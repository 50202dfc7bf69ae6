"""The readers of the program's own spans against hand-computed values on
synthetic records, None where their data is absent (the parent's program,
another kind of cell, an untraced run); and the program's spans in a real
CPU trace: on the host lane under their ``<cat>.<name>``, never on the
device's."""
import pytest
import torch

from bench.harness import runner
from bench.harness.profiling import Trace, traced
from bench.harness.record import RunRecord

# device work at 0.1-0.2 and 0.5-0.6 s of a 1 s window: idle 0.1 + 0.3 + 0.4 s,
# of which the two decode ranges cover 0.05 + 0.1 and 0.1 s and the prefill
# range 0.05 s: 0.3 s over two decode steps
DEVICE = [("gemm", 0.1, 0.2), ("k7", 0.5, 0.6)]
HOST = [("aten::mm", 0.0, 1.0), ("serve.decode", 0.05, 0.3), ("serve.prefill", 0.45, 0.55),
        ("serve.decode", 0.7, 0.8)]


def record(kind="serve", device=DEVICE, host=HOST, traced_run=True):
    trace = Trace(window_s=1.0, device=device, host=host) if traced_run else None
    return RunRecord(kind, {}, {}, {}, trace=trace)


@pytest.mark.parametrize("name,rec,want", [
    ("idle_in_step_ms.serve", record(), 150.0),
    ("idle_in_step_ms.serve", record(host=HOST[:1]), None),
    ("idle_in_step_ms.serve", record(kind="train"), None),
    ("idle_in_step_ms.serve", record(traced_run=False), None),
    ("idle_in_step_ms.serve", record(device=[]), None),
], ids=["value", "no-ranges", "train", "untraced", "no-device"])
def test_reader(name, rec, want):
    got = runner.load_reader(name).read(rec)
    assert got == (None if want is None else pytest.approx(want))


def test_program_spans_stay_on_the_host_lane():
    from repro_torch.obs.trace import Tracer
    tracer = Tracer()
    with traced(torch.device("cpu")) as box:
        with tracer.span("decode", cat="serve"):
            torch.ones(8).add_(1)
    trace = box[0]
    assert [n for n, _, _ in trace.host if n == "serve.decode"] == ["serve.decode"]
    assert not any(n.startswith(("serve.", "accum.", "step.")) for n, _, _ in trace.device)

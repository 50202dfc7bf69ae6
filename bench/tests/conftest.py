"""Small stand-ins of the benchmark's cells for CPU tests: each cell's own
files with the widths, depth and traffic shrunk."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.harness import spec  # noqa: E402


def tiny_cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    conf = dict(c.config, hidden_size=64, num_attention_heads=4, head_dim=16,
                intermediate_size=128, vocab_size=256, num_hidden_layers=2)
    if conf["num_key_value_heads"] > 1:
        conf["num_key_value_heads"] = 2
    w, t = copy.deepcopy(c.workload), copy.deepcopy(c.traffic)
    if c.kind == "train":
        t.update(global_batch=4, seq_len=32, n_microbatches=2)
        w["traced_steps"] = 1
    else:
        t.update(rate_per_s=16.0, prompt=dict(t["prompt"], median=24, min=16, max=64),
                 output=dict(t["output"], median=4, min=2, max=8))
        w["engine"] = {"max_batch": 4, "block_size": 16, "num_blocks": 64,
                       "max_blocks_per_seq": 5}
        w["warmup"] = {"prompts": [16, 64], "batch": 2, "batch_prompt": 64, "new_tokens": 2}
        w["check"]["served_tokens"] = 20
        w["traced_replay"] = {"warm_s": 0.2, "steps": 3}
    return spec.Cell(name, w, conf, t)


@pytest.fixture
def tiny():
    return tiny_cell

"""The paper's analytical resource model (sections 5-7, appendices A-C): a
copy of ``repro/core/calculator.py``, which the port may not import.

Reproduces, in closed form, the paper's configuration selection and its
training-time / memory predictions for the X_[x] family on the paper's
hardware, the A100 of its table A.1 (``Hardware``) — including Table 6.1
(fastest configs), Table 6.2 (memory breakdown), the scaling curves (figs.
4/5), the Ethernet scenario (fig. 8) and the offload intensities (fig. 7).
Every number it prints is the paper's hardware's, not the H100's.

Selection rules were reverse-engineered from §5 "Optimal configuration" and
validated against the paper's own Table 6.1 numbers (the JAX package's
benchmarks and tests check them; ``tests/test_torch_planner.py`` holds this
copy to that package's):

  * tensor parallelism: largest n_a <= 16 with overhead nu_net/nu_a <= 25%
    (eq. 12, NVLink); efficiency factor 1/(1+overhead);
  * baseline data parallelism: smallest micro-batch b_mu that keeps the
    gradient reduction (eq. 5) and — when offloading — the CPU-GPU stream
    (eq. 13) compute-bound, sharing PCIe between the two when both run;
  * pipeline baseline: n_l = d_l, b_mu from the offload constraint, extra
    micro-batches to cover the pipe transfer (n_mu_min = n_l (1+nu_net/nu_l),
    eq. 10), then fill the critical batch: n_b = floor(b_c / (n_mu_min b_mu)),
    n_mu = floor(b_c / (n_b b_mu));
  * improved (layered + modular, §3-4): b_mu = 1; n_mu just large enough to
    keep the (partitioned) reduction compute-bound (eqs. 8-9); n_b =
    floor(b_c/n_mu); n_l = n_mu (bubble (n_l-1)/(K n_mu), eq. §4); the
    pipeline p2p is left un-overlapped (cost nu_net/nu_l^impr, eq. 11).

Units: bytes are reported in GiB to match the paper's tables.
"""
from __future__ import annotations

import dataclasses
import math

GIB = 2.0 ** 30
YEAR = 365.0 * 86400
DAY = 86400.0


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A100-80GB node specs (paper appendix A, table A.1)."""
    c: float = 312e12            # peak fp16 flops
    mem: float = 80e9            # HBM bytes
    hbm_bw: float = 2039e9
    nvlink: float = 600e9        # in+out
    pcie: float = 63e9
    ib: float = 50e9             # InfiniBand 200 Gb/s
    cpu_gpu: float = 31.5e9
    ethernet: float = 6.25e9     # 25 Gb/s per GPU
    nvme: float = 3.2e9
    hdd: float = 0.1e9
    max_node: int = 16           # NVLink island size

    def nu(self, bw: float) -> float:
        """Arithmetic-intensity threshold (flops per byte) for a link."""
        return self.c / bw


@dataclasses.dataclass(frozen=True)
class XModel:
    """X_[x] family member (appendix B, eq. 1)."""
    x: int
    n_I: int = 4

    @property
    def d_a(self):
        return max(self.x // 2, 1)

    @property
    def d_h(self):
        return 2 * self.x

    @property
    def d_l(self):
        return self.x

    @property
    def d_s(self):
        return 16 * self.x

    @property
    def d_m(self):
        return self.x * self.x

    @property
    def p_layer(self) -> float:
        return (4 + 2 * self.n_I) * self.d_m ** 2

    @property
    def p(self) -> float:
        # paper's closed form 12 x^5 + 13 x^3 (includes attention extras)
        return 12.0 * self.x ** 5 + 13.0 * self.x ** 3

    @property
    def b_c(self) -> float:
        return 82.0 * self.x ** (2.0 / 3.0)

    def step_flops(self, b: float) -> float:
        """8 b d_s p: fwd + bwd + activation recompute (appendix C.1)."""
        return 8.0 * b * self.d_s * self.p


@dataclasses.dataclass
class Config:
    method: str
    n_b: int = 1
    n_l: int = 1
    n_a: int = 1
    n_mu: int = 1
    b_mu: int = 1
    offload: bool = False
    efficiency: float = 1.0
    time_s: float = 0.0
    memory: dict = dataclasses.field(default_factory=dict)

    @property
    def n_gpu(self) -> int:
        return self.n_b * self.n_l * self.n_a

    @property
    def b(self) -> int:
        return self.n_b * self.n_mu * self.b_mu

    def row(self) -> dict:
        return {"method": self.method, "b": self.b, "b_mu": self.b_mu,
                "n_mu": self.n_mu, "n_gpu": self.n_gpu, "n_b": self.n_b,
                "n_l": self.n_l, "n_a": self.n_a,
                "efficiency": round(self.efficiency, 3),
                "time_days": round(self.time_s / DAY, 2)}


# ---------------------------------------------------------------------------
# Arithmetic intensities (appendix C.4)
# ---------------------------------------------------------------------------
def nu_tensor(m: XModel, n_a: int) -> float:
    if n_a <= 1:
        return math.inf
    return (4 + 2 * m.n_I) * m.d_m / (3 * (n_a - 1))        # eq. 12


def nu_pipe_base(m: XModel, n_l: int) -> float:
    return (2 + m.n_I) * m.d_m * m.d_l / n_l                # eq. 10


def nu_pipe_impr(m: XModel) -> float:
    return (2 + m.n_I) * m.d_m                              # eq. 11


def tp_config(m: XModel, hw: Hardware, *, max_overhead: float = 0.25) -> tuple[int, float]:
    """Largest feasible n_a and its efficiency factor."""
    best, eff = 1, 1.0
    for n_a in range(2, hw.max_node + 1):
        ov = hw.nu(hw.nvlink) / nu_tensor(m, n_a)
        if ov <= max_overhead:
            best, eff = n_a, 1.0 / (1.0 + ov)
    return best, eff


# ---------------------------------------------------------------------------
# Memory breakdown (appendix C.3) — GiB, matching table 6.2
# ---------------------------------------------------------------------------
def memory_breakdown(m: XModel, cfg: Config, *, partitioned: bool) -> dict:
    n_gpu = cfg.n_gpu
    state = 12.0 * m.p / (n_gpu if partitioned else (cfg.n_l * cfg.n_a))
    ckpt = 2.0 * cfg.b * m.d_s * m.d_m * m.d_l / n_gpu
    buffers = 6.0 * m.p_layer / cfg.n_a
    # per-token layer activation bytes: ~48 d_m (a dozen bf16 tensors + grads)
    # + ~7 d_s d_a (scores/probs/grads); reconstructed from table 6.2 (None
    # row: 24.9 GiB at b_mu=4) to within ~5%.
    m0 = 48.0 * m.d_m + 7.0 * m.d_s * m.d_a
    act = cfg.b * m.d_s * m0 / (cfg.n_b * cfg.n_mu * cfg.n_a)
    out = {"state": state / GIB, "checkpoint": ckpt / GIB,
           "buffers": buffers / GIB, "activations": act / GIB}
    out["offloadable"] = out["state"] + out["checkpoint"]
    out["non_offloadable"] = out["buffers"] + out["activations"]
    return out


# ---------------------------------------------------------------------------
# Configuration selection per strategy (section 5)
# ---------------------------------------------------------------------------
def _bmu_data_base(m: XModel, hw: Hardware, net: float, *, offload: bool) -> int:
    """Smallest compute-bound micro-batch for plain data parallelism."""
    need = 4.0 * hw.nu(net) / (3.0 * m.d_s)                 # eq. 5 (n_mu = 1)
    if offload:
        # gradient reduction + CPU-GPU stream share PCIe (appendix A):
        # (4/3 + 1) bytes-per-token-flop against the PCIe threshold
        need = max(need, (7.0 / 3.0) * hw.nu(hw.pcie) / m.d_s)
        need = max(need, hw.nu(hw.cpu_gpu) / m.d_s)         # eq. 13
    return max(1, math.ceil(need))


def _steps(m: XModel) -> float:
    return 1e5   # the paper's 100k-step budget (section 6)


def _finish(m: XModel, hw: Hardware, cfg: Config, *, partitioned: bool) -> Config:
    cfg.time_s = _steps(m) * m.step_flops(cfg.b) / (cfg.n_gpu * hw.c * cfg.efficiency)
    cfg.memory = memory_breakdown(m, cfg, partitioned=partitioned)
    return cfg


def config_none(m: XModel, hw: Hardware) -> Config:
    cfg = Config("none", b_mu=4, offload=True)
    cfg.n_mu = int(m.b_c) // cfg.b_mu
    return _finish(m, hw, cfg, partitioned=False)


def config_data(m: XModel, hw: Hardware, *, partitioned: bool,
                net: float | None = None) -> Config:
    net = net or hw.ib
    needs_offload = 12.0 * m.p > 0.5 * hw.mem
    if partitioned:
        b_mu = max(1, math.ceil(2.0 * hw.nu(net) / m.d_s))  # eq. 7 (n_mu=1)
        b_mu = max(b_mu, _bmu_data_base(m, hw, net, offload=False))
        offload = False
    else:
        b_mu = _bmu_data_base(m, hw, net, offload=needs_offload)
        offload = needs_offload
    cfg = Config("data-part" if partitioned else "data-base",
                 b_mu=b_mu, offload=offload)
    cfg.n_b = max(1, int(m.b_c // b_mu))
    return _finish(m, hw, cfg, partitioned=partitioned)


def config_data_pipe_base(m: XModel, hw: Hardware, *, n_a: int = 1,
                          tp_eff: float = 1.0, net: float | None = None) -> Config:
    net = net or hw.ib
    n_l = m.d_l
    # offload only when the (model-parallel-split) state exceeds HBM; the
    # micro-batch is then sized by the CPU-GPU stream (eq. 13), else b_mu=1.
    offload = 12.0 * m.p / (n_l * n_a) > 0.9 * hw.mem
    b_mu = max(1, math.ceil(hw.nu(hw.cpu_gpu) / m.d_s)) if offload else 1
    nu_l = nu_pipe_base(m, n_l)
    n_mu_min = math.ceil(n_l * (1.0 + hw.nu(net) / nu_l))
    n_b = max(1, int(m.b_c // (n_mu_min * b_mu)))
    n_mu = max(n_mu_min, int(m.b_c // (n_b * b_mu)))
    cfg = Config("3d-base" if n_a > 1 else "pipe-base", n_b=n_b, n_l=n_l,
                 n_a=n_a, n_mu=n_mu, b_mu=b_mu, offload=offload)
    bubble = n_mu / (n_mu + n_l - 1)
    cfg.efficiency = bubble * tp_eff
    return _finish(m, hw, cfg, partitioned=False)


def config_improved(m: XModel, hw: Hardware, *, n_a: int = 1,
                    tp_eff: float = 1.0, partitioned: bool = True,
                    net: float | None = None, n_l: int | None = None) -> Config:
    net = net or hw.ib
    nu_net = hw.nu(net)
    if partitioned:
        n_mu = max(1, math.ceil(2.0 * nu_net / m.d_s))      # eq. 9
    else:
        n_mu = max(1, math.ceil(4.0 * nu_net / (3.0 * m.d_s)))  # eq. 8
    n_l = n_l if n_l is not None else min(n_mu, m.d_l)
    n_mu = max(n_mu, n_l)
    n_b = max(1, int(m.b_c // n_mu))
    cfg = Config("3d-impr" if n_a > 1 else "pipe-impr", n_b=n_b, n_l=n_l,
                 n_a=n_a, n_mu=n_mu, b_mu=1)
    K = max(m.d_l // n_l, 1)
    bubble = (K * n_mu) / (K * n_mu + n_l - 1)
    p2p = 1.0 / (1.0 + nu_net / nu_pipe_impr(m))            # un-overlapped
    cfg.efficiency = bubble * p2p * tp_eff
    return _finish(m, hw, cfg, partitioned=partitioned)


def config_data_tensor(m: XModel, hw: Hardware, *, partitioned: bool,
                       net: float | None = None) -> Config:
    net = net or hw.ib
    n_a, tp_eff = tp_config(m, hw)
    base = config_data(m, hw, partitioned=partitioned, net=net)
    cfg = Config("tensor-part" if partitioned else "tensor-base",
                 n_b=base.n_b, n_a=n_a, n_mu=1, b_mu=base.b_mu,
                 offload=base.offload and not partitioned)
    cfg.efficiency = tp_eff
    return _finish(m, hw, cfg, partitioned=partitioned)


def table_6_1(x: int = 160, hw: Hardware | None = None) -> list[dict]:
    """The paper's Table 6.1 for X_[x]."""
    hw = hw or Hardware()
    m = XModel(x)
    n_a, tp_eff = tp_config(m, hw)
    rows = [
        config_none(m, hw),
        config_data(m, hw, partitioned=False),
        config_data(m, hw, partitioned=True),
        config_data_pipe_base(m, hw),
        config_improved(m, hw, partitioned=True),
        config_data_tensor(m, hw, partitioned=False),
        config_data_tensor(m, hw, partitioned=True),
        config_data_pipe_base(m, hw, n_a=n_a, tp_eff=tp_eff),
        config_improved(m, hw, n_a=n_a, tp_eff=tp_eff, partitioned=True),
    ]
    out = []
    for cfg in rows:
        r = cfg.row()
        r.update({f"mem_{k}": round(v, 2) for k, v in cfg.memory.items()})
        out.append(r)
    return out


def fastest(m: XModel, hw: Hardware, *, method: str,
            net: float | None = None) -> Config:
    """Fastest configuration for a strategy family (figs. 4/5/8)."""
    n_a, tp_eff = tp_config(m, hw)
    if method == "baseline":
        cands = [config_data(m, hw, partitioned=False, net=net),
                 config_data_pipe_base(m, hw, net=net),
                 config_data_tensor(m, hw, partitioned=False, net=net),
                 config_data_pipe_base(m, hw, n_a=n_a, tp_eff=tp_eff, net=net)]
    elif method == "partitioned":
        cands = [config_data(m, hw, partitioned=True, net=net),
                 config_data_tensor(m, hw, partitioned=True, net=net)]
    else:
        cands = [config_improved(m, hw, partitioned=True, net=net),
                 config_improved(m, hw, n_a=n_a, tp_eff=tp_eff,
                                 partitioned=True, net=net)]
    return min(cands, key=lambda c: c.time_s)


def scaling_curve(xs, hw: Hardware | None = None, *, net: float | None = None):
    """fig. 4 (IB) / fig. 8 (Ethernet): min time + memory vs model size."""
    hw = hw or Hardware()
    rows = []
    for x in xs:
        m = XModel(x)
        row = {"x": x, "params": m.p}
        for method in ("baseline", "partitioned", "improved"):
            c = fastest(m, hw, method=method, net=net)
            row[f"{method}_days"] = c.time_s / DAY
            row[f"{method}_mem_gib"] = (c.memory["non_offloadable"]
                                        + c.memory["offloadable"])
            row[f"{method}_non_offload_gib"] = c.memory["non_offloadable"]
            row[f"{method}_ngpu"] = c.n_gpu
        rows.append(row)
    return rows


def offload_intensities(x: int, hw: Hardware | None = None) -> dict:
    """fig. 7: arithmetic intensity of streaming the state / checkpoints,
    vs the thresholds of each storage link (the §8.2 real-time checkpoint
    claim: partitioned state streams to NVMe/HDD at negligible cost)."""
    hw = hw or Hardware()
    m = XModel(x)
    impr = config_improved(m, hw, partitioned=True)
    nu_state_part = impr.b * m.d_s / 1.0                      # eq. 13 impr-part
    nu_state = impr.b * m.d_s / impr.n_b                      # eq. 13 impr
    nu_ckpt = (4 + 2 * m.n_I) * m.d_m                         # eq. 14
    return {
        "nu_state_impr_part": nu_state_part,
        "nu_state_impr": nu_state,
        "nu_ckpt": nu_ckpt,
        "thresholds": {
            "cpu_gpu": hw.nu(hw.cpu_gpu), "ethernet": hw.nu(hw.ethernet),
            "nvme": hw.nu(hw.nvme), "hdd": hw.nu(hw.hdd),
        },
        "state_streams_to_hdd": nu_state_part >= hw.nu(hw.hdd),
        "ckpt_streams_to_nvme": nu_ckpt >= hw.nu(hw.nvme),
    }

"""Mamba2's scan and mixer on the port (models/ssm.py) against a
step-by-step recurrence in float64 and against the plain reference's block
(models/longlrm_reference.py), at small sizes on the CPU."""
import math

import pytest
import torch

from f3d_gaus_torch.models import longlrm_reference as LR
from f3d_gaus_torch.models import ssm
from f3d_gaus_torch.utils import profiling

torch.set_num_threads(1)


def recurrence(x, dt, A, B, C, D):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t,
    one token at a time, in float64."""
    x, dt, A, B, C, D = (t.double() for t in (x, dt, A, B, C, D))
    b, L, h, p = x.shape
    per_group = h // B.shape[2]
    state = torch.zeros(b, h, p, B.shape[3], dtype=torch.float64)
    ys = []
    for t in range(L):
        Bt = B[:, t].repeat_interleave(per_group, 1)     # (b, h, n)
        Ct = C[:, t].repeat_interleave(per_group, 1)
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + dt[:, t, :, None, None] * x[:, t, :, :, None]
                 * Bt[:, :, None, :])
        ys.append((state * Ct[:, :, None, :]).sum(-1) + D[:, None] * x[:, t])
    return torch.stack(ys, 1)


def _inputs(L, decay, seed=0, b=2, h=4, p=3, n=5, g=2):
    """Scan inputs whose per-token decay exp(dt A) lies near `decay`:
    "slow" near 1 (the state crosses every chunk), "fast" near 0."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, L, h, p, generator=gen)
    dt = 0.05 + 0.1 * torch.rand(b, L, h, generator=gen)
    if decay == "slow":
        A = -(1e-3 + 1e-2 * torch.rand(h, generator=gen))
    else:
        A = -(20.0 + 20.0 * torch.rand(h, generator=gen))
    B = torch.randn(b, L, g, n, generator=gen)
    C = torch.randn(b, L, g, n, generator=gen)
    D = torch.randn(h, generator=gen)
    return x, dt, A, B, C, D


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("decay", ["slow", "fast"])
@pytest.mark.parametrize("L,chunk", [
    (64, 8),      # chunks divide L
    (64, 64),     # one chunk
    (61, 8),      # a ragged last chunk
    (50, 7),      # ragged, odd chunk
])
def test_ssd_matches_the_recurrence(L, chunk, decay):
    x, dt, A, B, C, D = _inputs(L, decay)
    want = recurrence(x, dt, A, B, C, D)
    got = ssm.ssd(x, dt, A, B, C, chunk, D=D)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) < 2e-6


@pytest.mark.parametrize("heads_a_block", [1, 3])
def test_ssd_head_blocks_and_superblocks(monkeypatch, heads_a_block):
    """Heads taken a few at a time (the block budget; a partial last
    block) and the chunk states passed in superblocks of 3 chunks (a
    partial last one) give the recurrence's outputs."""
    monkeypatch.setattr(ssm, "SCAN_SPAN", 3)
    x, dt, A, B, C, D = _inputs(83, "slow", seed=1, h=6, g=1)
    chunk = 6
    c = -(-83 // chunk)
    monkeypatch.setattr(ssm, "SSD_BLOCK_BYTES",
                        heads_a_block * 2 * c * chunk * chunk * 4)
    got = ssm.ssd(x, dt, A, B, C, chunk, D=D)
    assert _rel(got, recurrence(x, dt, A, B, C, D)) < 2e-6


def test_ssd_without_skip_and_its_counters():
    x, dt, A, B, C, D = _inputs(40, "slow", seed=2)
    with profiling.record():
        got = ssm.ssd(x, dt, A, B, C, 16)
        snap = profiling.snapshot()
    assert snap["counters"] == {"ssd.calls": 1, "ssd.tokens": 40}
    assert snap["spans"]["ssd"]["calls"] == 1
    want = recurrence(x, dt, A, B, C, torch.zeros_like(D))
    assert _rel(got, want) < 2e-6


def test_reference_scan_matches_the_recurrence():
    x, dt, A, B, C, D = _inputs(61, "slow", seed=3)
    assert _rel(LR.ssd_scan(x, dt, A, B, C, D, 8),
                recurrence(x, dt, A, B, C, D)) < 2e-6


def test_pass_states_matches_a_sequential_pass():
    gen = torch.Generator().manual_seed(4)
    s = torch.randn(2, 11, 3, 5, generator=gen)
    a = -torch.rand(2, 11, 3, generator=gen) * 3
    enter, state = [], torch.zeros(2, 3, 5)
    for k in range(11):
        enter.append(state)
        state = torch.exp(a[:, k])[..., None] * state + s[:, k]
    want = torch.stack(enter, 1)
    for span in (1, 4, 11, 32):
        got = ssm._pass_states(s, a, span)
        assert float((got - want).abs().max()) < 1e-5, span


CFG = LR.LongLRMConfig(width=32, d_state=8, head_dim=8, chunk=8, d_conv=4)


def _mixers(seed=0):
    ref = LR.Mamba2(CFG, torch.Generator().manual_seed(seed))
    port = ssm.Mamba2(32, d_state=8, d_conv=4, expand=2, head_dim=8,
                      chunk=8)
    port.load_state_dict(ref.state_dict())
    return port.eval(), ref.eval()


def test_mamba2_state_dict_keys_are_mamba_ssm_s():
    port, ref = _mixers()
    keys = set(port.state_dict())
    assert keys == set(ref.state_dict()) == {
        "in_proj.weight", "conv1d.weight", "conv1d.bias", "dt_bias", "A_log",
        "D", "norm.weight", "out_proj.weight"}
    sd = port.state_dict()
    # inner 64, 8 heads: z, x (64 each), B, C (8 each), dt (8)
    assert sd["in_proj.weight"].shape == (64 + 64 + 16 + 8, 32)
    assert sd["conv1d.weight"].shape == (80, 1, 4)
    assert sd["out_proj.weight"].shape == (32, 64)


def test_mamba2_initialisation_ranges():
    """dt = softplus(dt_bias) in [1e-3, 0.1], A = -exp(A_log) in [-16,
    -1], D = 1 (mamba_ssm's draws)."""
    port = ssm.Mamba2(64, d_state=8, head_dim=4,
                      generator=torch.Generator().manual_seed(5))
    dt = torch.nn.functional.softplus(port.dt_bias.detach())
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-7
    A = -torch.exp(port.A_log.detach())
    assert float(A.min()) >= -16 and float(A.max()) <= -1
    assert torch.equal(port.D, torch.ones(32))


@pytest.mark.parametrize("L", [24, 29])
def test_mamba2_matches_the_reference_block(L):
    port, ref = _mixers()
    u = torch.randn(2, L, 32, generator=torch.Generator().manual_seed(L))
    with torch.no_grad():
        got, want = port(u), ref(u)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@torch.no_grad()
def test_causal_conv_ignores_later_tokens():
    conv = ssm.CausalConv1d(6, 4, 1.0, torch.Generator().manual_seed(6))
    x = torch.randn(1, 10, 6)
    y = conv(x)
    x2 = x.clone()
    x2[:, 7:] += 1.0
    assert torch.equal(conv(x2)[:, :7], y[:, :7])
    ref = LR.Conv1d(6, 4, None)
    ref.load_state_dict(conv.state_dict())
    assert float((ref(x) - y).abs().max()) < 1e-5
    assert math.isclose(float(y[0, 0, 2]), float(
        conv.bias[2] + conv.weight[2, 0, 3] * x[0, 0, 2]), rel_tol=1e-6)

"""Mamba2's selective state-space mixer (Dao & Gu, "Transformers are SSMs:
Generalized Models and Efficient Algorithms Through Structured State Space
Duality", ICML 2024, arXiv:2405.21060), in plain torch and float32.  No
JAX counterpart.

`ssd` is the scan of one layer: per head, a state h (p × n) that decays by
exp(dt_t A) and takes in dt_t x_t B_tᵀ at each token, read out as y_t =
h_t C_t (+ D x_t).  It runs chunked, as the state-space duality computes
it: within a chunk of Q tokens the outputs are a masked (Q × Q) product,
the decay between two tokens exp(cumsum(dt A)) differenced, the segment-
sum form; each chunk's final state is a (p × Q)(Q × n) product; the states
are passed across chunks (`_pass_states`); each output then adds what the
state entering its chunk contributes.  Heads are taken in blocks so that
no (heads, chunks, Q, Q) intermediate exceeds SSD_BLOCK_BYTES; a ragged last
chunk is padded with dt = 0, which neither decays the state nor adds to
it.

`Mamba2` is mamba_ssm's `Mamba2` mixer at its defaults: in-projection to
(z, x, B, C, dt) with no bias, a causal depthwise conv1d (with bias) and
SiLU over (x, B, C), dt = softplus(dt + dt_bias), A = -exp(A_log), the
scan with a D skip per head, a gated RMSNorm (RMSNorm of y · SiLU(z), eps
1e-5) and an out-projection with no bias.  Its state_dict keys are
mamba_ssm's: `in_proj`, `conv1d`, `dt_bias`, `A_log`, `D`, `norm`,
`out_proj`.  Initialisation follows mamba_ssm (dt log-uniform in [1e-3,
0.1], floored at 1e-4, stored as its inverse softplus; A_log = log U[1,
16]; D = 1) with the projections and the conv drawn as N(0, std) and
zero biases.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from .gslrm import Linear

SSD_BLOCK_BYTES = 1 << 31   # one head block's (heads, chunks, Q, Q) decays
SCAN_SPAN = 32              # chunks a superblock of _pass_states
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4
A_MIN, A_MAX = 1.0, 16.0


def _segsum(a):
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i
    (0 on the diagonal), -inf above it; each sum taken directly, not as a
    difference of cumulative sums."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0).cumsum(-2)
    return x.masked_fill(~below.logical_or(
        torch.eye(T, dtype=torch.bool, device=a.device)), float("-inf"))


def _pass_states(s, a, span: int):
    """The state entering each chunk: E[k] = sum over j < k of
    exp(a[j+1] + ... + a[k-1]) s[j].  s (b, c, h, r): each chunk's own
    final state, a (b, c, h): each chunk's summed log decay.  Superblocks
    of `span` chunks take a (span × span) product each; the superblocks'
    carries are passed one after another."""
    b, c, h, r = s.shape
    nb = -(-c // span)
    pad = nb * span - c
    if pad:
        s = F.pad(s, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
    a4 = a.reshape(b, nb, span, h).permute(0, 1, 3, 2)       # (b, nb, h, T)
    s4 = s.reshape(b, nb, span, h, r).permute(0, 1, 3, 2, 4)
    # state after chunk m of a superblock, starting from zero
    after = torch.exp(_segsum(a4)) @ s4                    # (b, nb, h, T, r)
    total = a4.sum(-1)                                      # (b, nb, h)
    carry = s.new_zeros(b, h, r)
    starts = []
    for q in range(nb):
        starts.append(carry)
        carry = torch.exp(total[:, q])[..., None] * carry + after[:, q, :, -1]
    start = torch.stack(starts, 1)                          # (b, nb, h, r)
    after += torch.exp(a4.cumsum(-1))[..., None] * start[:, :, :, None]
    after = after.permute(0, 1, 3, 2, 4).reshape(b, nb * span, h, r)[:, :c]
    return torch.cat([s.new_zeros(b, 1, h, r), after[:, :-1]], 1)


@profiling.spanned("ssd")
def ssd(x, dt, A, B, C, chunk: int, D=None):
    """The selective scan of one layer in float32 (module docstring).

    x (b, L, h, p); dt (b, L, h), positive; A (h,), negative; B, C (b, L,
    g, n), heads h·i/g .. h·(i+1)/g reading group i; D (h,) or None.
    Returns y (b, L, h, p).  While tracing is on (utils.profiling) the
    call is span `ssd` and counts `ssd.calls` and `ssd.tokens` (L)."""
    b, L, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    profiling.count("ssd.calls")
    profiling.count("ssd.tokens", L)
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    skip = x
    Q = chunk
    c = -(-L // Q)
    pad = c * Q - L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(b, c, Q, h, p)
    dtc = dt.reshape(b, c, Q, h)
    Bc = B.reshape(b * c, Q, g, n)
    Cc = C.reshape(b * c, Q, g, n)
    acum = (dtc * A).cumsum(2)                             # (b, c, Q, h)
    hpg = h // g
    hb = max(1, min(hpg, SSD_BLOCK_BYTES // (b * c * Q * Q * 4)))
    blocks = [(i, slice(h0, min(h0 + hb, (i + 1) * hpg)))
              for i in range(g) for h0 in range(i * hpg, (i + 1) * hpg, hb)]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    y = x.new_empty(b, c, Q, h, p)
    states = x.new_empty(b, c, h, p, n)
    for i, hs in blocks:
        k = hs.stop - hs.start
        Bg, Cg = Bc[:, :, i], Cc[:, :, i]                  # (b·c, Q, n)
        ac = acum[..., hs].permute(0, 3, 1, 2)             # (b, k, c, Q)
        xdt = xc[:, :, :, hs] * dtc[:, :, :, hs, None]     # (b, c, Q, k, p)
        # within each chunk: (C_l · B_s) exp(acum_l - acum_s) for s <= l
        decay = (ac[..., :, None] - ac[..., None, :]).masked_fill_(
            ~causal, float("-inf")).exp_()
        decay.mul_(torch.bmm(Cg, Bg.transpose(1, 2)).view(b, 1, c, Q, Q))
        y[:, :, :, hs] = (decay @ xdt.permute(0, 3, 1, 2, 4)).permute(
            0, 2, 3, 1, 4)
        del decay
        # each chunk's final state from zero: sum_s exp(acum_Q - acum_s)
        # xdt_s B_s^T
        w = torch.exp(ac[..., -1:] - ac).permute(0, 2, 3, 1)  # (b, c, Q, k)
        xw = (xdt * w[..., None]).reshape(b * c, Q, k * p)
        states[:, :, hs] = torch.bmm(xw.transpose(1, 2), Bg).view(
            b, c, k, p, n)
    enter = _pass_states(states.view(b, c, h, p * n), acum[:, :, -1],
                         SCAN_SPAN)
    enter = enter.view(b, c, h, p, n)
    del states
    for i, hs in blocks:
        k = hs.stop - hs.start
        e = enter[:, :, hs].permute(0, 1, 4, 2, 3).reshape(b * c, n, k * p)
        off = torch.bmm(Cc[:, :, i], e).view(b, c, Q, k, p)
        y[:, :, :, hs] += off * torch.exp(acum[..., hs])[..., None]
    y = y.view(b, c * Q, h, p)[:, :L]
    if D is not None:
        y = y + skip * D.float()[:, None]
    return y


def _normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class CausalConv1d(nn.Module):
    """Depthwise causal convolution over the tokens: out_t = bias +
    sum_k weight[:, 0, k] x_{t - K + 1 + k} (zeros before the first);
    weight (channels, 1, K) as nn.Conv1d holds it."""

    def __init__(self, channels, kernel, std, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_normal((channels, 1, kernel), std,
                                           generator))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        """x (b, L, channels) -> (b, L, channels)."""
        K = self.weight.shape[-1]
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     padding=K - 1, groups=x.shape[-1])
        return y[..., :x.shape[1]].transpose(1, 2)


class GatedRMSNorm(nn.Module):
    """RMSNorm(y · SiLU(z)) · weight, mamba_ssm's RMSNormGated with the
    gate before the norm and one group."""

    def __init__(self, d, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, y, z):
        y = y * F.silu(z)
        return y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight


class Mamba2(nn.Module):
    """mamba_ssm's Mamba2 mixer at its defaults (module docstring):
    (b, L, d_model) -> (b, L, d_model)."""

    def __init__(self, d_model, d_state=128, d_conv=4, expand=2, head_dim=64,
                 ngroups=1, chunk=256, std=0.02, generator=None):
        super().__init__()
        self.d_inner = expand * d_model
        self.heads = self.d_inner // head_dim
        self.head_dim, self.d_state, self.ngroups = head_dim, d_state, ngroups
        self.chunk = chunk
        conv_dim = self.d_inner + 2 * ngroups * d_state
        self.in_proj = Linear(d_model, self.d_inner + conv_dim + self.heads,
                              std, generator, bias=False)
        self.conv1d = CausalConv1d(conv_dim, d_conv, std, generator)
        u = torch.rand(self.heads, generator=generator)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                       + math.log(DT_MIN)).clamp_min(DT_FLOOR)
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        u = torch.rand(self.heads, generator=generator)
        self.A_log = nn.Parameter(torch.log(A_MIN + (A_MAX - A_MIN) * u))
        self.D = nn.Parameter(torch.ones(self.heads))
        self.norm = GatedRMSNorm(self.d_inner)
        self.out_proj = Linear(self.d_inner, d_model, std, generator,
                               bias=False)

    def forward(self, u):
        b, L, _ = u.shape
        gn = self.ngroups * self.d_state
        z, xbc, dt = torch.split(self.in_proj(u), [
            self.d_inner, self.d_inner + 2 * gn, self.heads], -1)
        xbc = F.silu(self.conv1d(xbc))
        x, B, C = torch.split(xbc, [self.d_inner, gn, gn], -1)
        y = ssd(x.reshape(b, L, self.heads, self.head_dim),
                F.softplus(dt + self.dt_bias), -torch.exp(self.A_log),
                B.reshape(b, L, self.ngroups, self.d_state),
                C.reshape(b, L, self.ngroups, self.d_state), self.chunk,
                D=self.D)
        return self.out_proj(self.norm(y.reshape(b, L, self.d_inner), z))

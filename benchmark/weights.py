"""The predictor's weights, made by the benchmark from the seed.

EDM's initialisation (the program's and the reference's `xavier_uniform`
with its per-layer gains and the head's per-group table), with every
uniform drawn on the card in ONE call from a `torch.Generator` seeded from
the run's seed and handed out in construction order.  The reference's
frozen predictor is built from that stream; the program's predictor loads
the reference's state_dict (the same keys), so both sides start from the
same numbers and neither makes them.
"""
from __future__ import annotations

import math

import torch


class _Count:
    """A stream that only counts what construction takes (meta tensors)."""

    def __init__(self):
        self.n = 0

    def take(self, shape):
        self.n += math.prod(shape)
        return torch.empty(shape, device="meta")


class Stream:
    """`n` uniforms in [0, 1) (or standard normals) drawn in one call on
    `device`, taken in order by the reference's initialisers
    (`layers.xavier_uniform`, the towers' `_randn`)."""

    def __init__(self, n: int, seed: int, device, normal: bool = False):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        draw = torch.randn if normal else torch.rand
        self.buf = draw(n, generator=g, device=device)
        self.pos = 0

    def take(self, shape):
        n = math.prod(shape)
        if self.pos + n > self.buf.numel():
            raise RuntimeError("the weight stream ran out")
        out = self.buf[self.pos:self.pos + n].view(shape)
        self.pos += n
        return out


def reference_predictor(pipeline_fields: dict, seed: int, device):
    """The reference's GaussianPredictor at the configuration's widths,
    its weights drawn from `seed` on `device`."""
    from .reference import config as RC
    from .reference import predictor as RP
    pcfg = RC.PipelineConfig(**pipeline_fields).predictor_config()
    return _built(lambda g: RP.GaussianPredictor(pcfg, g), seed, device,
                  normal=False)


def _built(make, seed, device, normal):
    """make(stream) on `device` from one draw of as many numbers as its
    construction takes (counted first on the meta device)."""
    count = _Count()
    with torch.device("meta"):
        make(count)
    stream = Stream(count.n, seed, device, normal)
    with torch.device(device):
        model = make(stream)
    del stream
    return model.to(device).eval()


def reference_towers(seed: int, device) -> dict:
    """The reference's VGG16 and CLIP ViT-B/32 visual towers at full
    width, frozen, He / 0.02-normal initialised from one draw each."""
    from .reference import clip as RCL
    from .reference import vgg as RVG
    return {"vgg": _built(RVG.VGG16, seed, device, True).requires_grad_(False),
            "clip": _built(lambda g: RCL.CLIPVisual(7, g), seed + 1, device,
                           True).requires_grad_(False)}


def program_towers(reference: dict, device) -> dict:
    """The program's towers holding the reference towers' weights."""
    from f3d_gaus_torch.models import clip as CL
    from f3d_gaus_torch.models import vgg as VG
    with torch.device(device):
        towers = {"vgg": VG.VGG16(None), "clip": CL.CLIPVisual(7, None)}
    for k, t in towers.items():
        t.to(device).load_state_dict(reference[k].state_dict())
        t.eval().requires_grad_(False)
    return towers


def program_predictor(pipeline_fields: dict, state_dict: dict, device):
    """The program's GaussianPredictor holding `state_dict` (its own
    initial draws, made on the card, are overwritten)."""
    from f3d_gaus_torch.models import predictor as P
    from f3d_gaus_torch.pipeline import config as C
    pcfg = C.PipelineConfig(**pipeline_fields).predictor_config()
    with torch.device(device):
        model = P.GaussianPredictor(pcfg, None)
    model = model.to(device)
    model.load_state_dict(state_dict)
    return model.eval()

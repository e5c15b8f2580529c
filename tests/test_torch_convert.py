"""models/convert.py's checkpoint conversion against the JAX package's: a
seeded small predictor saved as the reference's checkpoint is laid out
(checkpoint['model'], a DDP 'module.' prefix, the predictor under
'gaussian_predictor.network_with_offset.', as tests/test_model.py builds
one) converts to the same weights key for key, loads with strict=True, and
a dropped key raises KeyError in both packages."""
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.models import convert as JConv
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_torch.models import convert as TConv
from f3d_gaus_torch.models import predictor as TP

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

SMALL = dict(resolution=32, base_dim=32, num_blocks=1, attn_resolutions=(8,))
NET = "gaussian_predictor.network_with_offset."


def _checkpoint(path, drop=None):
    """Saves the seeded predictor in the reference's layout, with one key
    outside the predictor and, when `drop` is given, that predictor key
    left out; returns the predictor."""
    model = TP.GaussianPredictor(TP.PredictorConfig(**SMALL),
                                 torch.Generator().manual_seed(0))
    sd = {"module." + NET + k: v for k, v in model.state_dict().items()
          if k != drop}
    sd["module.gaussian_predictor.other_head.weight"] = torch.ones(3)
    torch.save({"model": sd}, path)
    return model


def test_convert_checkpoint_matches_jax(tmp_path):
    path = tmp_path / "ref.pt"
    model = _checkpoint(path)
    got = TConv.convert_checkpoint(path, TP.PredictorConfig(**SMALL))
    want = TConv.params_from_jax(JConv.convert_checkpoint(
        str(path), JP.PredictorConfig(**SMALL)))
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], model.state_dict()[k]), k
    fresh = TP.GaussianPredictor(TP.PredictorConfig(**SMALL))
    fresh.load_state_dict(got, strict=True)


@pytest.mark.parametrize("drop", ["encoder.enc.32x32_block0.conv0.weight",
                                  "encoder.dec.32x32_aux_norm.bias",
                                  "out.weight"])
def test_convert_checkpoint_raises_on_a_missing_key(tmp_path, drop):
    """A key the predictor needs, dropped from the checkpoint: KeyError from
    the port's convert_checkpoint, as from the JAX package's plan walk."""
    path = tmp_path / "ref.pt"
    _checkpoint(path, drop=drop)
    with pytest.raises(KeyError):
        TConv.convert_checkpoint(path, TP.PredictorConfig(**SMALL))
    with pytest.raises(KeyError):
        JConv.convert_checkpoint(str(path), JP.PredictorConfig(**SMALL))


def test_convert_predictor_takes_the_net_name():
    """convert_predictor reads under 'gaussian_predictor.{net_name}.': the
    same weights under another network name convert alike."""
    model = TP.GaussianPredictor(TP.PredictorConfig(**SMALL),
                                 torch.Generator().manual_seed(1))
    sd = {"gaussian_predictor.network_without_offset." + k: v
          for k, v in model.state_dict().items()}
    got = TConv.convert_predictor(sd, TP.PredictorConfig(**SMALL),
                                  net_name="network_without_offset")
    want = TConv.params_from_jax(JConv.convert_predictor(
        sd, JP.make_plan(JP.PredictorConfig(**SMALL)),
        net_name="network_without_offset"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

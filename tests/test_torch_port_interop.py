"""Reference ``.pt`` interop of the port's acoustic model against the JAX
package's, on the CPU. Reference-format files are written here by the JAX
package's ``save_torch_checkpoint`` (torch only), or by the port: each
package reads the other's, with bit-equal parameters; the port's ``infer``
on a ``.pt`` matches the JAX package's on the same file; a trainer warm
start from a ``.pt`` equals one from the ``.ckpt`` after a step."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config.registry import build_config as jbuild
from isp_tts_tpu.models.acoustic import AcousticModel as JModel
from isp_tts_tpu.models.acoustic import AcousticModelConfig as JConfig
from isp_tts_tpu.models.acoustic import interop as jinterop
from isp_tts_tpu.training import checkpoint as jckpt
from isp_tts_tpu_torch import checkpoint as pckpt
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic import interop as pinterop
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
from isp_tts_tpu_torch.models.base import Model
from torch_port_common import SMALL, SMALL_MHA, jax_flat, perturb, t

CONFIGS = {"mqa": SMALL, "mha": SMALL_MHA,
           # the exact-erf GELU, which the reference's "gelu" means
           "gelu_exact": {**SMALL, "encoder": {**SMALL["encoder"], "transformer_layer": {
               **SMALL["encoder"]["transformer_layer"],
               "feed_forward": {"inner_dim": 128, "activation": "gelu_exact"}}}}}


def jax_model(cfg, seed=11):
    jm = JModel(jbuild(JConfig, cfg), rngs=nnx.Rngs(0))
    jm.eval()
    perturb(jm, seed)
    b = jm.temporal_adaptor.predictor.linear.bias
    b.value = b.value.at[0].add(1.5)  # durations of a few frames a token
    return jm


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def files(request, tmp_path_factory):
    """(JAX model, its .ckpt, its reference .pt written by the JAX package)."""
    d = tmp_path_factory.mktemp(f"interop_{request.param}")
    jm = jax_model(CONFIGS[request.param])
    jm.save_pretrained(d / "m.ckpt")
    jckpt.save_torch_checkpoint(jm, d / "m.pt")
    return request.param, jm, d / "m.ckpt", d / "m.pt"


def test_jax_written_pt_loads_bit_equal_to_the_ckpt(files):
    name, _, ckpt, pt = files
    from_ckpt = AcousticModel.from_pretrained(ckpt, device="cpu").state_dict()
    from_pt = AcousticModel.from_pretrained(pt, device="cpu")
    assert set(from_pt.state_dict()) == set(from_ckpt)
    for k, v in from_pt.state_dict().items():
        assert torch.equal(v, from_ckpt[k]), k
    # the reference's "gelu" is built as exact erf GELU, as the JAX import does
    ff = from_pt.encoder.layers[0].feed_forward
    x = torch.linspace(-3, 3, 7)
    torch.testing.assert_close(ff.act(x), torch.nn.functional.gelu(x), rtol=0, atol=0)


def test_port_infer_on_a_pt_matches_jax_infer_on_it(files):
    """JAX-drawn noise into both packages' models loaded from one ``.pt``."""
    _, _, _, pt = files
    jm = JModel.from_pretrained(str(pt))
    jm.eval()
    pm = AcousticModel.from_pretrained(pt, device="cpu")
    rng = np.random.RandomState(0)
    lens = np.array([13, 9], np.int32)
    tokens = rng.randint(2, 11, size=(2, 16)).astype(np.int32)
    tokens[np.arange(16)[None, :] >= lens[:, None]] = 0
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    jmel, jad = jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens), max_dec_len=96,
                         key=key, speaker=jnp.asarray([0, 1]), pitch_factor=1.1)
    mel, ad = pm.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=96,
                       noise=t(noise), speaker=torch.tensor([0, 1]), pitch_factor=1.1)
    np.testing.assert_array_equal(ad.dec_lengths.numpy(), np.asarray(jad.dec_lengths))
    assert (ad.dec_lengths.numpy() > 0).all()
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4, rtol=0)


def test_port_written_pt_loads_in_jax_bit_equal(files, tmp_path):
    name, jm, ckpt, _ = files
    pm = AcousticModel.from_pretrained(ckpt, device="cpu")
    pckpt.save_torch_checkpoint(pm, tmp_path / "port.pt")
    blob = jckpt.load_torch_checkpoint(tmp_path / "port.pt")
    assert blob["format"] == "torch"
    config = jinterop.import_torch_config(blob["model"]["config"])
    state = jinterop.convert_torch_state(blob["model"]["state"])
    want = jax_flat(jm)
    assert set(state) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    # the JAX package builds the same model from it
    jm2 = JModel.from_pretrained(str(tmp_path / "port.pt"))
    assert jax_flat(jm2).keys() == want.keys(), name
    for k, v in jax_flat(jm2).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert config["encoding_map"] == jm.config.encoding_map


def test_reference_state_equals_the_jax_packages(files):
    """The port's reference names and tensors for a model are the JAX
    package's for the same model, key for key and bit for bit; and the
    two maps invert each other."""
    _, jm, ckpt, pt = files
    pm = AcousticModel.from_pretrained(ckpt, device="cpu")
    ours = pinterop.export_torch_state(pm.state_dict())
    theirs = jinterop.export_torch_state(jax_flat(jm))
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    back = pinterop.convert_torch_state(ours)
    assert set(back) == set(pm.state_dict())
    assert set(pckpt.load_checkpoint(pt)["model"]["state"]) == set(theirs)


def test_configs_map_as_the_jax_package_maps_them():
    cfg = {"a": {"activation": "gelu_exact"}, "b": [{"activation": "gelu"},
                                                    {"activation": "relu"}], "c": 3}
    assert pinterop.export_torch_config(cfg) == jinterop.export_torch_config(cfg)
    assert pinterop.import_torch_config(cfg) == jinterop.import_torch_config(cfg)
    assert pinterop.import_torch_config(pinterop.export_torch_config(cfg))["a"] == {
        "activation": "gelu_exact"}


class PickledConfig(dict):
    """A config object that ``weights_only`` refuses, as it refuses the
    reference's pickled OmegaConf containers."""


def test_pickled_reference_config_loads_with_a_warning(files, tmp_path, caplog):
    _, _, _, pt = files
    blob = torch.load(pt, weights_only=True)
    blob["model"]["config"] = PickledConfig(blob["model"]["config"])
    torch.save(blob, tmp_path / "pickled.pt")
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        got = pckpt.load_checkpoint(tmp_path / "pickled.pt")
    assert "unpickling it in full" in caplog.text
    assert type(got["model"]["config"]) is dict
    assert got["model"]["config"] == pckpt.load_checkpoint(pt)["model"]["config"]


def test_a_model_without_a_converter_refuses_pt(tmp_path):
    with pytest.raises(NotImplementedError, match="no torch-checkpoint converter"):
        Model.convert_torch_checkpoint({}, {})


def test_trainer_warm_start_from_pt_equals_warm_start_from_ckpt(tmp_path):
    from test_torch_port_trainer import build
    from torch_port_common import write_toy_dataset

    root = tmp_path / "toy"
    write_toy_dataset(root)
    src = build(root, tmp_path / "src")
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        for p in src.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    src.model.save_pretrained(tmp_path / "w.ckpt")
    jckpt.save_torch_checkpoint(JModel.from_pretrained(str(tmp_path / "w.ckpt")),
                                tmp_path / "w.pt")
    runs = {}
    for suffix in ("ckpt", "pt"):
        trainer = build(root, tmp_path / suffix, batch_size=8, warm_start=True,
                        resume_from_checkpoint=str(tmp_path / f"w.{suffix}"))
        loaded = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        trainer.train()
        assert trainer.state.global_step == 1
        runs[suffix] = loaded, trainer.model.state_dict()
    for k, v in runs["ckpt"][0].items():
        assert torch.equal(runs["pt"][0][k], v), k
        assert torch.equal(v, src.model.state_dict()[k].cpu()), k
    for k, v in runs["ckpt"][1].items():
        assert torch.equal(runs["pt"][1][k], v), k

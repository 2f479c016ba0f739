"""The port's multi-card layer without processes, on the CPU.

- ``make_mesh``: the JAX package's shapes and errors over a world of ranks,
  the ranks laid out data × model × seq × stage;
- ``shard_batch``: a data rank's contiguous rows (arrays, per-row lists,
  stacked chunks), the global batch's padded lengths kept;
- ``shard_params`` over the port's names against the JAX rules' choices on
  the same model over a model axis of the conftest's virtual devices,
  including the GLU halves and an indivisible tensor;
- ``shard_params`` on a stacked layer stack: the JAX rules' choices with
  the split dim shifted right by one past the depth axis, each depth slice
  a layer's share;
- ``barrier`` and ``gather_to_host`` in one process; the seq and stage
  axes build, a model axis beside a stage axis builds, and a layout that
  splits the seq or stage axis without its process group raises (no rank
  computes the whole alone);
- the dropout hash of a shard: the plain versions of K1/K2 and K5a/K5b
  called with a batch offset and a head slice give the keep masks of the
  matching slice of the whole call bit for bit and outputs within 1e-6;
  at offset 0 the masks are the JAX package's;
- ``Synthesizer(devices=["cpu", "cpu"])``: bit-equal to one device serving
  each card's rows with that card's share of the batch's noise, and within
  1e-4 of the mel's max-abs of one device serving the whole batch (the CPU's
  products round a 2-row and a 4-row batch differently by ~1e-6, which the
  soft durations amplify to 6.9e-5 of mels of magnitude ~3); and against
  the JAX ``Synthesizer(mesh=...)`` over 2 virtual devices on the same
  texts, seed and flow noise (1e-4 of the mel's max-abs, the bound of
  ``__graft_entry__.py:_check_mesh_serving``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_port_parallel_workers as W
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.ops import flash_attention as jfa
from isp_tts_tpu.parallel import mesh as jmesh
from isp_tts_tpu.serving import Synthesizer as JSynthesizer
from isp_tts_tpu.serving import SynthesizerConfig as JSynthesizerConfig
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.ops import flash_attention as fa
from isp_tts_tpu_torch.parallel import context as pctx
from isp_tts_tpu_torch.parallel import mesh as pmesh
from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig
from isp_tts_tpu_torch.training.trainer_config import TrainerConfig
from torch_port_common import jax_flat, perturb


# -- the mesh ----------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(data=-1, model=2), dict(data=-1, model=1),
                                  dict(data=-1, model=1, seq=2, stage=2),
                                  dict(data=2, model=4), dict(data=-1, model=8)])
def test_make_mesh_shapes_match_jax(axes):
    ours = pmesh.make_mesh(**axes, world_size=8)
    theirs = jmesh.make_mesh(**axes)
    assert ours.shape == dict(theirs.shape)
    assert ours.size == 8


@pytest.mark.parametrize("axes,world", [(dict(data=-1, model=3), 8),
                                        (dict(data=3, model=2), 8),
                                        (dict(data=-1, model=2, seq=2), 6)])
def test_make_mesh_errors_match_jax(axes, world):
    with pytest.raises(ValueError) as ours:
        pmesh.make_mesh(**axes, world_size=world)
    with pytest.raises(ValueError) as theirs:
        jmesh.make_mesh(**axes, devices=jax.devices()[:world])
    assert str(ours.value) == str(theirs.value)


def test_ranks_lay_out_data_by_model_with_groups_along_each_axis():
    mesh = pmesh.make_mesh(data=-1, model=2, world_size=8)
    assert [mesh.coords(r) for r in (0, 1, 2, 7)] == [
        dict(data=0, model=0, seq=0, stage=0), dict(data=0, model=1, seq=0, stage=0),
        dict(data=1, model=0, seq=0, stage=0), dict(data=3, model=1, seq=0, stage=0)]
    assert mesh.lines("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.lines("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]


@pytest.mark.parametrize("kwargs", [{"mesh_seq_axis": 2},
                                    {"mesh_pipeline_axis": 2, "pipeline_microbatches": 2},
                                    {"mesh_seq_axis": 2, "mesh_pipeline_axis": 2},
                                    {"mesh_model_axis": 2, "mesh_seq_axis": 2}])
def test_seq_and_stage_axes_build(kwargs):
    cfg = TrainerConfig(**kwargs)
    assert all(getattr(cfg, k) == v for k, v in kwargs.items())


def test_model_with_stage_builds_and_no_split_runs_without_its_group():
    cfg = TrainerConfig(mesh_model_axis=2, mesh_pipeline_axis=2)
    assert (cfg.mesh_model_axis, cfg.mesh_pipeline_axis) == (2, 2)
    for axis in ("seq", "stage"):
        layout = pmesh.make_mesh(data=1, world_size=2, **{axis: 2})
        with pytest.raises(ValueError, match=f"must name its {axis} axis"):
            pctx.ParallelContext(layout=layout)
        with pytest.raises(ValueError, match="has no process group"):
            pctx.ParallelContext(layout=layout, **{f"{axis}_axis": axis})
    ctx = pctx.ParallelContext(seq_axis="seq", stage_axis="stage")  # size-1 axes: alone
    assert (ctx.axis_group("seq"), ctx.axis_group("stage")) == (None, None)


def test_an_nccl_rank_without_its_own_card_raises_before_any_group(monkeypatch):
    """A second NCCL rank on a host with one card raises at set-up, with a
    message, before a process group exists (no hang, no gloo fallback)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one NCCL rank a card"):
        pmesh.init_distributed("nccl", init_method="file:///nonexistent/store",
                               world_size=2, rank=1, local_rank=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="nccl .* or gloo"):
        pmesh.init_distributed("mpi")


def test_one_process_context_has_no_groups_and_a_split_mesh_needs_them():
    ctx = pmesh.make_context(pmesh.make_mesh())
    assert (ctx.data_size, ctx.model_size, ctx.groups) == (1, 1, {})
    with pytest.raises(RuntimeError, match="init_distributed"):
        pmesh.make_context(pmesh.make_mesh(data=2, world_size=2))


# -- batches -------------------------------------------------------------------------------


def _context(data=1, model=1, rank=0):
    return pctx.parallel_context(layout=pmesh.make_mesh(data=data, model=model,
                                                        world_size=data * model), rank=rank)


def test_shard_batch_keeps_the_data_ranks_rows_at_the_global_lengths():
    batch = W.global_batch(B=4)
    batch["filename"] = ["a", "b", "c", "d"]
    batch["note"] = "kept"
    for rank, rows in ((0, slice(0, 2)), (1, slice(2, 4)), (2, slice(0, 2)),
                       (3, slice(2, 4))):
        with _context(data=2, model=2, rank=rank) as ctx:  # ranks 0, 1: data row 0
            assert ctx.data_rank == rank // 2
            out = pmesh.shard_batch(batch)
        want = slice(0, 2) if rank < 2 else slice(2, 4)
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(out[k], v[want])
        assert out["filename"] == batch["filename"][want] and out["note"] == "kept"
        assert out["mel"].shape[1:] == batch["mel"].shape[1:]  # the global padding
        del rows
    stacked = {"mel": np.stack([batch["mel"]] * 3)}
    with _context(data=2, rank=1):
        np.testing.assert_array_equal(pmesh.shard_batch(stacked, stacked=True)["mel"],
                                      stacked["mel"][:, 2:4])
        with pytest.raises(ValueError, match="does not split"):
            pmesh.shard_batch({"x": np.zeros((3, 2))})
    assert pmesh.shard_batch(batch) == batch


# -- tensor-parallel rules -------------------------------------------------------------------


def _split_by_jax(jm, model: int) -> set[str]:
    """JAX names of the parameters the JAX TP rules shard over "model"."""
    mesh = jmesh.make_mesh(data=-1, model=model)
    state = jmesh.shard_params(nnx.state(jm, nnx.Param), mesh)
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    out = set()
    for path, leaf in flat:
        name = jmesh._path_str(path)
        name = name[: -len(".value")] if name.endswith(".value") else name
        if "model" in str(leaf.sharding.spec):
            out.add(name)
    return out


def _config(inner: int, heads: int, glu_inner: int = 64) -> dict:
    """PAR without dropout, ``heads`` a layer, the encoder's feed-forward
    ``inner`` wide and the decoder's GLU ``glu_inner``."""
    cfg = W.without_dropout(W.PAR)
    for part in (cfg["encoder"], cfg["decoder"], cfg["temporal_adaptor"]["predictor"],
                 cfg["temporal_adaptor"]["embedding"]):
        layer = (part.get("transformer") or part)["transformer_layer"]
        layer["attention"]["heads"] = heads
    cfg["encoder"]["transformer_layer"]["feed_forward"]["inner_dim"] = inner
    cfg["decoder"]["transformer_layer"]["feed_forward"]["inner_dim"] = glu_inner
    return cfg


@pytest.mark.parametrize("model,inner,heads", [(2, 64, 2), (4, 30, 4)])
def test_shard_params_makes_the_jax_rules_choices(model, inner, heads):
    """The same tensors split as the JAX rules shard, each to its rank's
    share (a GLU ``fc1``'s value and gate halves split alike); an inner dim
    the model axis does not divide (30 over 4) stays whole in both."""
    cfg = _config(inner, heads)
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    flat = jax_flat(jm)
    full = AcousticModel(build_config(AcousticModelConfig, cfg))
    full.load_jax_state(flat)
    jax_name = {n: j for n, (j, _) in full.jax_names().items()}
    want = _split_by_jax(jm, model)
    for rank in range(model):
        pm = AcousticModel(build_config(AcousticModelConfig, cfg))
        pm.load_jax_state(flat)
        with _context(model=model, rank=rank) as ctx:
            splits = pmesh.shard_params(pm, ctx)
        assert {jax_name[n] for n in splits} == want
        whole = dict(full.named_parameters())
        for name, p in pm.named_parameters():
            if name not in splits:
                assert torch.equal(p, whole[name]), name
                continue
            dim, halves = splits[name]
            parts = whole[name].chunk(halves, dim=dim)
            local = torch.cat([h.chunk(model, dim=dim)[rank] for h in parts], dim=dim)
            assert torch.equal(p.data, local), name
            assert p.tp_split == (dim, halves)
        assert splits["decoder.layers.0.feed_forward.fc1.weight"] == (0, 2)  # GLU halves
        assert ("encoder.layers.0.feed_forward.fc1.weight" in splits) == (inner % model == 0)
        assert all(getattr(p, "tp_partial", False) == (".to_kv." in n or ".rel_pos." in n)
                   for n, p in pm.named_parameters()
                   if n.split(".attention.")[0] + ".attention.to_q.weight" in splits)


def test_shard_params_shifts_the_rules_on_a_stacked_stack():
    """The stacked decoder (``stack.*``, depth 2) splits the tensors the JAX
    rules shard (``tests/test_parallel.py::test_shard_params_stacked_tp_shift``:
    the stacked ``fc1`` kernel (depth, in, out) on axis 2, here the weight
    (depth, out, in) on dim 1), each rank keeping its share of every
    layer's slice; the stacked layer then runs split on each slice."""
    cfg = W.without_dropout(W.PAR_STAGE)
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    full = AcousticModel(build_config(AcousticModelConfig, cfg))
    full.load_jax_state(jax_flat(jm))
    jax_name = {n: j for n, (j, _) in full.jax_names().items()}
    want = _split_by_jax(jm, 2)
    whole = dict(full.named_parameters())
    for rank in range(2):
        pm = AcousticModel(build_config(AcousticModelConfig, cfg))
        pm.load_state_dict(full.state_dict())
        with _context(model=2, rank=rank) as ctx:
            splits = pmesh.shard_params(pm, ctx)
        assert {jax_name[n] for n in splits} == want
        assert splits["decoder.stack.feed_forward.fc1.weight"] == (1, 2)  # GLU halves
        assert splits["decoder.stack.feed_forward.fc2.weight"] == (2, 1)
        assert splits["decoder.stack.attention.to_q.weight"] == (1, 1)
        for name, (dim, halves) in splits.items():
            p = pm.get_parameter(name)
            assert torch.equal(p.data, pmesh.slice_split(whole[name], dim, halves, rank, 2))
            assert torch.equal(pmesh.local_part(p, whole[name], ctx), p.data)
        stack = pm.decoder.stack
        assert stack.attention.tp is not None and stack.feed_forward.tp is not None
        assert stack.attention.to_kv.weight.tp_partial


def test_heads_and_glu_halves_split_whole_or_not_at_all():
    """Differences by design: the kernels run whole heads, and a GLU's two
    halves split alike, so an attention layer whose heads the model axis
    does not divide (2 over 4), or a GLU whose halves it does not (30 over
    4), stays whole, where the JAX rules shard ``to_q``'s rows (128 over
    4) or ``fc1``'s (60 over 4) and XLA computes across the cut. Both
    compute the same function."""
    cfg = _config(64, 2, glu_inner=30)
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    pm = AcousticModel(build_config(AcousticModelConfig, cfg))
    with _context(model=4) as ctx:
        splits = pmesh.shard_params(pm, ctx)
    jax_split = _split_by_jax(jm, 4)
    assert {"encoder.layers.0.attention.to_q.kernel",
            "decoder.layers.0.feed_forward.fc1.kernel"} <= jax_split
    assert "decoder.layers.0.feed_forward.fc2.kernel" not in jax_split
    assert not any(".attention." in n or n.startswith("decoder.") for n in splits)
    assert pm.encoder.layers[0].attention.tp is None
    assert pm.decoder.layers[0].feed_forward.tp is None
    assert pm.encoder.layers[0].feed_forward.tp is not None  # 64 over 4


def test_barrier_and_gather_to_host_in_one_process():
    pmesh.barrier("test")  # no process group: returns at once
    tree = {"a": torch.arange(4.0), "b": [torch.ones(2, 2, dtype=torch.bfloat16)],
            "c": np.int32(3)}
    out = pmesh.gather_to_host(tree)
    assert isinstance(out["a"], np.ndarray) and isinstance(out["b"][0], np.ndarray)
    np.testing.assert_array_equal(out["a"], np.arange(4.0))
    assert out["b"][0].dtype == np.float32 and int(out["c"]) == 3
    assert pmesh.process_local_mesh_info() == (1, 0)


# -- the dropout hash of a shard ----------------------------------------------------------


def _attention_inputs(B=4, N=20, M=24, H=4, per_head=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    kv = (B, M, H, 64) if per_head else (B, M, 64)
    q = torch.randn(B, N, H, 64, generator=g)
    k, v = torch.randn(kv, generator=g), torch.randn(kv, generator=g)
    do = torch.randn(B, N, H, 64, generator=g)
    slopes = torch.rand(2, H, generator=g) * 0.3
    kl = torch.tensor([24, 17, 24, 9][:B], dtype=torch.int32)
    ql = torch.tensor([20, 20, 13, 16][:B], dtype=torch.int32)
    return q, k, v, do, slopes, kl, ql


SEED = torch.tensor([987654], dtype=torch.int32)
RATE = 0.1


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("rows,heads", [((2, 4), (0, 4)), ((0, 4), (2, 4)), ((1, 3), (1, 3))])
def test_a_shards_masks_are_the_slice_of_the_whole_calls(per_head, rows, heads):
    B, N, H, M = 4, 20, 4, 24
    thresh = fa.dropout_thresh(RATE)
    (b0, b1), (h0, h1) = rows, heads
    if per_head:
        whole = fa.head_keep_mask(B, H, N, M, SEED, thresh)[b0:b1, h0:h1]
        part = fa.head_keep_mask(b1 - b0, h1 - h0, N, M, SEED, thresh, b0, h0, H)
    else:
        whole = fa.mqa_keep_mask(B, N, H, M, SEED, thresh)[b0:b1, :, h0:h1]
        part = fa.mqa_keep_mask(b1 - b0, N, h1 - h0, M, SEED, thresh, b0, h0, H)
    assert torch.equal(part, whole)


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("rows,heads", [((2, 4), (0, 4)), ((0, 4), (2, 4))])
def test_a_shards_plain_attention_is_the_slice_of_the_whole_call(per_head, rows, heads):
    """Forward o and lse, and the backward's dq and slope gradients (a
    batch shard's slope gradient is its rows' share, summed over shards;
    K1's dk/dv of a head shard sum over shards to the whole), within 1e-6."""
    q, k, v, do, slopes, kl, ql = _attention_inputs(per_head=per_head)
    fwd, bwd = ((fa.flash_attention_reference, fa.flash_bwd_reference) if per_head
                else (fa.mqa_attention_reference, fa.mqa_bwd_reference))
    H = q.shape[2]
    o, lse = fwd(q, k, v, slopes, kl, 0.125, 0, ql, False, RATE, SEED)
    grads = bwd(q, k, v, slopes, kl, ql, SEED, o, lse, do, 0.125, 0, False, RATE)
    (b0, b1), (h0, h1) = rows, heads
    lse_full = lse.reshape(q.shape[0], -1, H) if not per_head else lse.transpose(1, 2)
    kv = (slice(b0, b1), slice(None)) + ((slice(h0, h1),) if per_head else ())
    args = (q[b0:b1, :, h0:h1].contiguous(), k[kv].contiguous(), v[kv].contiguous(),
            slopes[:, h0:h1].contiguous(), kl[b0:b1], 0.125, 0, ql[b0:b1], False, RATE, SEED,
            b0, h0, H)
    o_s, lse_s = fwd(*args)
    torch.testing.assert_close(o_s, o[b0:b1, :, h0:h1], rtol=0, atol=1e-6)
    lse_s = lse_s.reshape(b1 - b0, -1, h1 - h0) if not per_head else lse_s.transpose(1, 2)
    live = torch.isfinite(lse_full[b0:b1, :, h0:h1])
    assert torch.equal(torch.isfinite(lse_s), live)
    torch.testing.assert_close(lse_s[live], lse_full[b0:b1, :, h0:h1][live], rtol=0, atol=1e-6)
    lse_arg = (lse_s.reshape(b1 - b0, -1) if not per_head else lse_s.transpose(1, 2)).contiguous()
    dq, dk, dv, dsl = bwd(*args[:5], ql[b0:b1], SEED, o_s, lse_arg,
                          do[b0:b1, :, h0:h1].contiguous(), 0.125, 0, False, RATE, b0, h0, H)
    torch.testing.assert_close(dq, grads[0][b0:b1, :, h0:h1], rtol=0, atol=1e-6)
    if (b0, b1) == (0, 4):  # a head shard: its heads' slope gradients whole
        torch.testing.assert_close(dsl, grads[3][:, h0:h1], rtol=0, atol=1e-6)
    if per_head:
        torch.testing.assert_close(dk, grads[1][kv], rtol=0, atol=1e-6)
        torch.testing.assert_close(dv, grads[2][kv], rtol=0, atol=1e-6)
    elif (h0, h1) == (0, 4):  # a batch shard of K1: its rows' dk, dv
        torch.testing.assert_close(dk, grads[1][b0:b1], rtol=0, atol=1e-6)
        torch.testing.assert_close(dv, grads[2][b0:b1], rtol=0, atol=1e-6)


def test_head_shards_of_k1_sum_to_the_whole_calls_key_gradients():
    q, k, v, do, slopes, kl, ql = _attention_inputs()
    o, lse = fa.mqa_attention_reference(q, k, v, slopes, kl, 0.125, 0, ql, False, RATE, SEED)
    _, dk, dv, _ = fa.mqa_bwd_reference(q, k, v, slopes, kl, ql, SEED, o, lse, do, 0.125, 0,
                                        False, RATE)
    sums = [torch.zeros_like(dk), torch.zeros_like(dv)]
    for h0 in (0, 2):
        args = (q[:, :, h0:h0 + 2].contiguous(), k, v, slopes[:, h0:h0 + 2].contiguous(), kl)
        o_s, lse_s = fa.mqa_attention_reference(*args, 0.125, 0, ql, False, RATE, SEED, 0, h0, 4)
        _, dk_s, dv_s, _ = fa.mqa_bwd_reference(*args, ql, SEED, o_s, lse_s,
                                                do[:, :, h0:h0 + 2].contiguous(), 0.125, 0,
                                                False, RATE, 0, h0, 4)
        sums[0] += dk_s
        sums[1] += dv_s
    torch.testing.assert_close(sums[0], dk, rtol=0, atol=1e-6)
    torch.testing.assert_close(sums[1], dv, rtol=0, atol=1e-6)


def test_at_offset_0_the_masks_are_the_jax_packages():
    B, N, H, M = 2, 6, 3, 7
    thresh = fa.dropout_thresh(RATE)
    sref = jnp.asarray(SEED.numpy())
    ours = fa.mqa_keep_mask(B, N, H, M, SEED, thresh, 0, 0, H).reshape(B, N * H, M)
    ref = np.stack([np.asarray(jfa._mqa_keep(sref, jnp.int32(b), 0, 0, N * H, M, N * H, M,
                                             thresh)) for b in range(B)])
    np.testing.assert_array_equal(ours.numpy(), ref)
    ours = fa.head_keep_mask(B, H, N, M, SEED, thresh, 0, 0, H)
    ref = np.stack([np.stack([np.asarray(jfa._head_keep(
        sref, jnp.int32(b), jnp.int32(h), H, 0, 0, N, M, N, M, thresh))
        for h in range(H)]) for b in range(B)])
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert fa.hash_origin(True, N, M, H) == (H, 0) == fa.hash_origin(False, N, M, H)


# -- serving over several devices -----------------------------------------------------------

TEXTS = ["abc def", "bad", "fade cab", "head"]
SERVE = dict(text_buckets=(16,), frame_budgets=(64,), frames_per_token=4.0, steps=1)


@pytest.fixture(scope="module")
def models():
    cfg = W.without_dropout(W.PAR)
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    jm.eval()
    perturb(jm, 11)
    b = jm.temporal_adaptor.predictor.linear.bias  # ~exp(1.5) - 1 frames a token
    b.value = b.value.at[0].add(1.5)
    pm = AcousticModel(build_config(AcousticModelConfig, cfg))
    pm.load_jax_state(jm.state_dict())
    return jm, pm.eval()


def test_two_devices_serve_what_one_serves(models):
    _, pm = models
    one = Synthesizer(pm, SynthesizerConfig(**SERVE))
    two = Synthesizer(pm, SynthesizerConfig(**SERVE), devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[1] is not two.replicas[0]
    got = two(TEXTS, seed=7)
    # each card's rows: one device on those rows with their share of the noise
    tokens, lens, fb, B = one.prepare(TEXTS)
    noise = one._noise(tokens.shape, 7)
    halves = [one._infer(torch.from_numpy(tokens[r]).long(), torch.from_numpy(lens[r]), fb,
                         None, noise[r]) for r in (slice(0, 2), slice(2, 4))]
    mel = torch.cat([m for m, _ in halves]).numpy()
    frames = torch.cat([ad.dec_lengths for _, ad in halves]).numpy()
    for i, a in enumerate(got):
        np.testing.assert_array_equal(a, mel[i, :frames[i]])
    for a, b in zip(got, one(TEXTS, seed=7)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    three = Synthesizer(pm, SynthesizerConfig(**SERVE), devices=["cpu"] * 3)
    assert three.prepare(TEXTS)[0].shape[0] == 6  # bucket 4 up to a multiple of 3


def test_two_devices_serve_what_the_jax_mesh_serves(models, monkeypatch):
    jm, pm = models
    meshed = JSynthesizer(jm, JSynthesizerConfig(**SERVE),
                          mesh=jmesh.make_mesh(data=-1, model=1, devices=jax.devices()[:2]))
    want = meshed(TEXTS, seed=7)
    two = Synthesizer(pm, SynthesizerConfig(**SERVE), devices=["cpu", "cpu"])
    # the flow noise the JAX program draws from its key for the padded batch
    monkeypatch.setattr(two, "_noise", lambda shape, seed: torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), (*shape, 3)))))
    got = two(TEXTS, seed=7)
    for a, b in zip(got, want):
        assert a.shape == b.shape, "the frame counts differ"
        if b.size:
            assert np.abs(a - b).max() <= 1e-4 * (np.abs(b).max() + 1e-9)

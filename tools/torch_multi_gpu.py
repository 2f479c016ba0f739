#!/usr/bin/env python3
"""The port on several cards of one host: data- and model-parallel
fine-tuning, a recipe through ``--distributed``, and one batch served over
the cards, each held to one card.

    python3 tools/torch_multi_gpu.py [--cards 4]

Needs ``--cards`` NVIDIA cards; it starts its ranks itself (one process a
card, NCCL through a ``file://`` store under the work directory):

1. env     - every card's name and power limit (nvidia-smi); the kernels
             built once, in parallel, before any rank starts.
2. finetune - the committed checkpoint's fine-tuning (batch 32, text 48 x
             mel 320, AdamW 2e-4, clip 1.0, the batch chip_smoke.py makes)
             at data 1 (one card), data N and data N/2 x model 2: 3 steps in
             f32, each step's loss and gradient norm within FT_F32_BOUND
             (relative) of one card's; then in bf16, the checkpoint's
             precision, 3 warm steps and FT_TIMED timed ones, finite. Per
             configuration: host ms a step, the device-busy share of one
             warm step (rank 0, torch.profiler), peak memory of each card,
             and the gradient all-reduce's device ms a step (rank 0, CUDA
             events around each bucket).
3. serve   - ``Synthesizer(devices=[cuda:0..N-1])`` against one card on 8
             sentences, both on the one card's durations: each card's rows
             equal to one card serving them, the whole batch within the
             smoke's bounds (chip_smoke.serve_over_devices); warm ms of a
             batch of 8 each.
4. recipe  - ``acoustic/core_fast`` through ``torchrun --nproc_per_node N -m
             isp_tts_tpu_torch.train --distributed`` on a dataset the
             Synthesizer writes (chip_smoke.py's), warm-started from the
             committed checkpoint, 8 steps: exit 0, rank 0 alone writes one
             checkpoint at step 8.

    python3 tools/torch_multi_gpu.py --axes [--cards 4]

runs the seq and stage axes alone (needs 4 cards):

5. axes    - the fine-tuning of phase 2 at data 2 x seq 2 (``flash: ring`` in
             the encoder and the decoder), data 2 x stage 2 (the decoder
             stacked, 4 microbatches), seq 2 x stage 2 and model 2 x stage 2
             (each stage's stacked layers split over its 2 model ranks),
             each against one card with the same model (ringing alone on a
             size-1 seq axis; the stacked decoder run locally): 3 f32 steps
             within FT_F32_BOUND (the first step's gap reported apart, and
             model 2 x stage 2's held within FT_F32_FIRST_BOUND), then bf16
             host ms a step, peak memory of each card and the collectives'
             device ms a step by kind (rotate, all-gather, all-reduce; rank
             0, CUDA events around each call).
6. axis-recipes - ``acoustic/core_sp`` and ``acoustic/core_pp`` through
             ``torchrun --nproc_per_node 4 ... --distributed`` (data 2 x seq
             2, data 2 x stage 2), and ``acoustic/core_pp`` with
             ``trainer.mesh_model_axis=2`` (model 2 x stage 2), on the
             dataset of phase 4, warm-started from the committed checkpoint,
             8 steps each: exit 0, one checkpoint at step 8 (core_pp's with
             the decoder's global stacked tensors).

    python3 tools/torch_multi_gpu.py --tf32-study [--cards 4]

needs one card: where the f32 gap between data N and one card comes
from. It runs the f32 fine-tuning steps of phase 2 at data 1 (twice: the
run-to-run floor) and at data N with its N ranks all on cuda:0 over gloo
(the ranks' arithmetic of data N, gloo's sums for NCCL's), each with
cuDNN's TF32 convolutions on (PyTorch's default) and off, and prints each
pair's largest relative loss and gradient-norm gap over the steps.

The last line is one JSON object with every number. Any failure exits
non-zero. ``--rehearse`` runs the same control flow on the CPU with gloo at a
small size (batch 4, tiny recipe widths, 2 timed steps), for checking the
script without a card; its numbers are not measurements.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

#: f32 steps of a split run against one card: loss and gradient norm,
#: relative (``__graft_entry__.py:dryrun_multichip``'s bound)
FT_F32_BOUND = 5e-3
FT_F32_STEPS = 3
FT_WARM, FT_TIMED = 3, 20
SERVE_SENTENCES = smoke.TRAIN_SENTENCES[:8]
RECIPE_STEPS = 8
RECIPE_TRAIN, RECIPE_VALID = 256, 32


def say(phase: str, t0: float, text: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s {text}", flush=True)


# -- a rank -------------------------------------------------------------------------------


def rank_main(args) -> int:
    """One rank of a fine-tuning configuration: f32 steps, then timed bf16
    steps; writes ``<work>/<config>_rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.parallel import mesh
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    work = Path(args.work)
    cuda = not args.rehearse
    warm, timed = (1, 2) if args.rehearse else (FT_WARM, FT_TIMED)
    one_card = args.tf32 is not None  # --tf32-study: every rank on cuda:0 over gloo
    timed_calls: dict = {}
    dev = mesh.init_distributed("gloo" if one_card or not cuda else "nccl",
                                init_method=f"file://{work / (args.config + '.store')}",
                                world_size=args.world, rank=args.rank, local_rank=args.rank,
                                timeout_s=300)
    if one_card and cuda:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = args.tf32 == "on"
        torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    out = {"rank": args.rank, "device": str(dev)}
    try:
        experiment = json.loads((work / "experiment.json").read_text())
        batch = {k: v.to(dev) for k, v in torch.load(work / "batch.pt").items()}

        def build_model():
            if not args.stacked:
                model = AcousticModel.from_pretrained(smoke.CKPT, device=dev)
            else:  # the decoder stacked, its per-layer weights translated
                from isp_tts_tpu_torch.checkpoint import load_checkpoint
                from isp_tts_tpu_torch.models.acoustic.model import AcousticModelConfig

                blob = load_checkpoint(smoke.CKPT)["model"]
                model = AcousticModel(build_config(AcousticModelConfig,
                                                   smoke.stacked_config(blob["config"])))
                model.load_jax_state(blob["state"])
                model = model.to(dev)
            if args.ring:
                smoke.set_flash(model.encoder, "ring")
                smoke.set_flash(model.decoder, "ring")
            return model

        def trainer(precision):
            import dataclasses

            cfg = build_config(TrainerConfig, experiment["trainer"])
            cfg.precision, cfg.mesh_model_axis = precision, args.model
            cfg.mesh_seq_axis, cfg.mesh_pipeline_axis = args.seq, args.stage
            cfg.pipeline_microbatches = 2 if args.rehearse else 4
            cfg.output_dir = str(work / f"{args.config}_runs")
            model = build_model()
            loss = AcousticModelLoss(build_config(AcousticLossConfig, experiment["criterion"]))
            gen = torch.Generator(device=dev).manual_seed(7)
            if not (one_card and cuda):
                tr = Trainer(model, loss, cfg, device=dev, generator=gen)
                if args.ring and args.seq == 1:  # one card: the ring of one
                    tr.parallel_ctx = dataclasses.replace(tr.parallel_ctx, seq_axis="seq")
                return tr
            # the trainer refuses a gloo group on a card (no silent fallback
            # from NCCL); this study runs one on purpose
            get_backend, dist.get_backend = dist.get_backend, lambda group=None: "nccl"
            try:
                return Trainer(model, loss, cfg, device=dev, generator=gen)
            finally:
                dist.get_backend = get_backend

        tr = trainer("fp32")
        hist = tr.train([batch], FT_F32_STEPS)
        out["f32"] = {k: [h[k] for h in hist] for k in ("loss", "stats/grad_norm")}
        ctx = tr.parallel_ctx
        out["layout"] = {"data": ctx.data_size, "model": ctx.model_size, "seq": ctx.seq_size,
                         "stage": ctx.stage_size}
        del tr
        if one_card:  # f32 steps only
            (work / f"{args.config}_rank{args.rank}.json").write_text(json.dumps(out))
            return 0
        tr = trainer("bf16")
        tr.train([batch], warm)
        events: list = []
        reduce = mesh._bucketed_all_reduce

        def timed_reduce(tensors, group):
            if not cuda:
                return reduce(tensors, group)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            reduce(tensors, group)
            end.record()
            events.append((start, end))

        def timed_call(kind, fn):
            def call(*a, **k):
                if not cuda:
                    return fn(*a, **k)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                result = fn(*a, **k)
                end.record()
                timed_calls.setdefault(kind, []).append((start, end))
                return result
            return call

        mesh._bucketed_all_reduce = timed_reduce
        originals = (mesh._rotate, mesh._all_gather, dist.all_reduce)
        if args.seq > 1 or args.stage > 1:
            mesh._rotate = timed_call("rotate", mesh._rotate)
            mesh._all_gather = timed_call("all_gather", mesh._all_gather)
            dist.all_reduce = timed_call("all_reduce", dist.all_reduce)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        step_ms, hist = [], []
        for _ in range(timed):
            t = time.perf_counter()
            hist += tr.train([batch], 1)  # the metrics come back as floats: synced
            step_ms.append(1e3 * (time.perf_counter() - t))
        mesh._bucketed_all_reduce = reduce
        mesh._rotate, mesh._all_gather, dist.all_reduce = originals
        if cuda:
            torch.cuda.synchronize(dev)
            out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
            out["all_reduce_ms_per_step"] = sum(s.elapsed_time(e) for s, e in events) / timed
            out["all_reduce_calls_per_step"] = len(events) / timed
            out["collectives_ms_per_step"] = {
                kind: sum(s.elapsed_time(e) for s, e in calls) / timed
                for kind, calls in timed_calls.items()}
            out["collectives_calls_per_step"] = {kind: len(calls) / timed
                                                 for kind, calls in timed_calls.items()}
        out["bf16_ms"] = step_ms
        out["bf16_finite"] = bool(all(np.isfinite(v) for h in hist for v in h.values()))
        out["bf16_loss"] = [h["loss"] for h in hist]
        if args.rank == 0 and cuda:
            busy: list = []
            smoke.say = lambda phase, t0, text="": busy.append(text)
            out["busy_ms"] = smoke.phase_profile(0.0, lambda: tr.train([batch], 1), "warm step")
            out["profile"] = busy[-1] if busy else ""
        else:  # the other ranks take the profiled step too
            tr.train([batch], 1)
    finally:
        dist.destroy_process_group()
    (work / f"{args.config}_rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def run_config(work: Path, name: str, world: int, model: int, rehearse: bool,
               timeout: float, tf32: str | None = None, seq: int = 1, stage: int = 1,
               ring: bool = False, stacked: bool = False) -> list[dict]:
    """Start ``world`` ranks of one configuration (with ``tf32``, all on
    cuda:0 over gloo, f32 steps only; ``ring``: the encoder and decoder
    ``flash: ring``; ``stacked``: the decoder stacked); their results by
    rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if rehearse:
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        cmd = [sys.executable, __file__, "--rank", str(rank), "--world", str(world),
               "--model", str(model), "--config", name, "--work", str(work)]
        if rehearse:
            cmd.append("--rehearse")
        if tf32 is not None:
            cmd += ["--tf32", tf32]
        cmd += ["--seq", str(seq), "--stage", str(stage)]
        cmd += ["--ring"] * ring + ["--stacked"] * stacked
        log = open(work / f"{name}_rank{rank}.log", "w")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        log.close()
    deadline = time.monotonic() + timeout
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=max(deadline - time.monotonic(), 1.0)))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if any(c != 0 for c in codes):
        logs = "\n".join(f"--- rank {r} ---\n"
                         + (work / f"{name}_rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        raise AssertionError(f"{name}: ranks exited {codes}\n{logs}")
    return [json.loads((work / f"{name}_rank{r}.json").read_text()) for r in range(world)]


# -- the parent ----------------------------------------------------------------------------


def write_batch(t0, work: Path, rehearse: bool) -> None:
    """The fine-tuning setup the ranks read: the checkpoint's trainer and
    criterion configuration and chip_smoke.py's batch."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.serving import Synthesizer

    dev = "cpu" if rehearse else "cuda:0"
    experiment = load_checkpoint(smoke.CKPT)["experiment"]["config"]
    (work / "experiment.json").write_text(json.dumps(
        {"trainer": experiment["trainer"], "criterion": experiment["criterion"]}))
    synth = Synthesizer.from_pretrained(smoke.CKPT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    batch, _, _ = smoke.training_batch(synth, gen)
    torch.save({k: v.cpu() for k, v in batch.items()}, work / "batch.pt")
    del synth
    say("finetune", t0, f"batch of {smoke.BATCH}: tokens {batch['text_vector_len'].tolist()}, "
        f"frames {batch['mel_len'].tolist()}")


def phase_finetune(t0, work: Path, cards: int, rehearse: bool) -> dict:
    write_batch(t0, work, rehearse)
    configs = [("data1", 1, 1), (f"data{cards}", cards, 1),
               (f"data{cards // 2}_model2", cards, 2)]
    results = {}
    for name, world, model in configs:
        t = time.perf_counter()
        ranks = run_config(work, name, world, model, rehearse, timeout=600)
        results[name] = ranks
        r0 = ranks[0]
        warm = r0["bf16_ms"][2:] or r0["bf16_ms"]
        say("finetune", t0, f"{name} ({world} rank(s), layout {r0['layout']}): f32 losses "
            f"{[round(x, 6) for x in r0['f32']['loss']]}, grad norms "
            f"{[round(x, 5) for x in r0['f32']['stats/grad_norm']]}; bf16 finite "
            f"{all(r['bf16_finite'] for r in ranks)}, host ms a step (steps 3-{FT_TIMED}) "
            f"median {np.median(warm):.2f} mean {np.mean(warm):.2f}; peak MiB by rank "
            f"{[round(r.get('peak_mib', 0.0), 1) for r in ranks]}; all-reduce ms a step "
            f"{r0.get('all_reduce_ms_per_step', 0.0):.3f} in "
            f"{r0.get('all_reduce_calls_per_step', 0.0):.1f} calls; {r0.get('profile', '')}; "
            f"{time.perf_counter() - t:.1f} s with the ranks' start")
    one = results["data1"][0]["f32"]
    errs = {}
    for name, ranks in results.items():
        errs[name] = rel_gap(ranks[0]["f32"], one)
        if not all(r["bf16_finite"] for r in ranks):
            raise AssertionError(f"{name}: a bf16 metric went non-finite")
    say("finetune", t0, f"f32, {FT_F32_STEPS} steps, loss and gradient norm against one card, "
        f"largest relative error: {errs} (bound {FT_F32_BOUND:.0e})")
    if max(errs.values()) > FT_F32_BOUND:
        raise AssertionError(f"split fine-tuning against one card: {errs}")
    return {"f32_rel_err": errs,
            "configs": {name: {
                "ranks": len(ranks), "layout": ranks[0]["layout"],
                "host_ms_median": float(np.median(ranks[0]["bf16_ms"][2:] or ranks[0]["bf16_ms"])),
                "host_ms_mean": float(np.mean(ranks[0]["bf16_ms"][2:] or ranks[0]["bf16_ms"])),
                "busy_ms": ranks[0].get("busy_ms"),
                "peak_mib": [r.get("peak_mib") for r in ranks],
                "all_reduce_ms_per_step": ranks[0].get("all_reduce_ms_per_step"),
                "f32": ranks[0]["f32"]} for name, ranks in results.items()}}


def rel_gap(a: dict, b: dict, steps: int | None = None) -> float:
    """The largest relative gap of ``a``'s f32 losses and gradient norms,
    step by step (the first ``steps``; all), from ``b``'s."""
    return max(abs(x - y) / max(abs(y), 1e-12) for key in a
               for x, y in zip(a[key][:steps], b[key][:steps]))


#: (name, world, model, seq, stage, ring, stacked) of the axes'
#: configurations, each after its one-card reference
AXES_CONFIGS = (
    ("data1_ring", 1, 1, 1, 1, True, False), ("data2_seq2", 4, 1, 2, 1, True, False),
    ("data1_stacked", 1, 1, 1, 1, False, True), ("data2_stage2", 4, 1, 1, 2, False, True),
    ("model2_stage2", 4, 2, 1, 2, False, True),
    ("data1_ring_stacked", 1, 1, 1, 1, True, True), ("seq2_stage2", 4, 1, 2, 2, True, True),
)
#: model 2 x stage 2's first f32 step against one card's, relative
FT_F32_FIRST_BOUND = 1e-5


def phase_axes(t0, work: Path, rehearse: bool) -> dict:
    """The seq and stage configurations against one card with the same
    model, f32, then their bf16 readings."""
    write_batch(t0, work, rehearse)
    results, refs, errs = {}, {}, {}
    for name, world, model, seq, stage, ring, stacked in AXES_CONFIGS:
        t = time.perf_counter()
        ranks = run_config(work, name, world, model, rehearse, timeout=900, seq=seq,
                           stage=stage, ring=ring, stacked=stacked)
        r0 = ranks[0]
        if world == 1:
            refs[(ring, stacked)] = r0["f32"]
        else:
            one = refs[(ring, stacked)]
            errs[name] = {"first_step": rel_gap(r0["f32"], one, 1),
                          f"{FT_F32_STEPS}_steps": rel_gap(r0["f32"], one)}
        results[name] = ranks
        warm = r0["bf16_ms"][2:] or r0["bf16_ms"]
        say("axes", t0, f"{name} ({world} rank(s), layout {r0['layout']}, ring {ring}, stacked "
            f"decoder {stacked}): f32 losses {[round(x, 6) for x in r0['f32']['loss']]}, grad "
            f"norms {[round(x, 5) for x in r0['f32']['stats/grad_norm']]}"
            + (f" (against one card: {errs[name]})" if name in errs else "")
            + f"; bf16 finite {all(r['bf16_finite'] for r in ranks)}, host ms a step (steps "
            f"3-{FT_TIMED}) median {np.median(warm):.2f} mean {np.mean(warm):.2f}; peak MiB by "
            f"rank {[round(r.get('peak_mib', 0.0), 1) for r in ranks]}; collectives ms a step "
            f"{ {k: round(v, 3) for k, v in r0.get('collectives_ms_per_step', {}).items()} } "
            f"in { {k: round(v, 1) for k, v in r0.get('collectives_calls_per_step', {}).items()} }"
            f" calls, gradient all-reduce {r0.get('all_reduce_ms_per_step', 0.0):.3f} ms; "
            f"{r0.get('profile', '')}; {time.perf_counter() - t:.1f} s with the ranks' start")
        if not all(r["bf16_finite"] for r in ranks):
            raise AssertionError(f"{name}: a bf16 metric went non-finite")
    worst = max(e[f"{FT_F32_STEPS}_steps"] for e in errs.values())
    say("axes", t0, f"f32, {FT_F32_STEPS} steps, loss and gradient norm against one card with "
        f"the same model, largest relative error: {errs} (bound {FT_F32_BOUND:.0e})")
    if worst > FT_F32_BOUND or errs["model2_stage2"]["first_step"] > FT_F32_FIRST_BOUND:
        raise AssertionError(f"seq/stage fine-tuning against one card: {errs}")
    return {"f32_rel_err": errs,
            "configs": {name: {
                "ranks": len(ranks), "layout": ranks[0]["layout"],
                "host_ms_median": float(np.median(ranks[0]["bf16_ms"][2:] or ranks[0]["bf16_ms"])),
                "host_ms_mean": float(np.mean(ranks[0]["bf16_ms"][2:] or ranks[0]["bf16_ms"])),
                "busy_ms": ranks[0].get("busy_ms"),
                "peak_mib": [r.get("peak_mib") for r in ranks],
                "collectives_ms_per_step": ranks[0].get("collectives_ms_per_step"),
                "all_reduce_ms_per_step": ranks[0].get("all_reduce_ms_per_step"),
                "f32": ranks[0]["f32"]} for name, ranks in results.items()}}


def phase_tf32_study(t0, work: Path, cards: int, rehearse: bool) -> dict:
    """Data 1 and data ``cards`` on one card, cuDNN's TF32 on and off, f32
    steps: each pair's relative gap (:func:`rel_gap`)."""
    write_batch(t0, work, rehearse)
    runs = {}
    for tf32 in ("on", "off"):
        for name, world in ((f"data1_{tf32}", 1), (f"data1_{tf32}_again", 1),
                            (f"data{cards}_{tf32}", cards)):
            runs[name] = run_config(work, name, world, 1, rehearse, timeout=600,
                                    tf32=tf32)[0]["f32"]
            say("tf32-study", t0, f"{name}: losses {runs[name]['loss']}, grad norms "
                f"{runs[name]['stats/grad_norm']}")
    pairs = {}
    for tf32 in ("on", "off"):
        pairs[f"data1 again, tf32 {tf32}"] = (f"data1_{tf32}_again", f"data1_{tf32}")
        pairs[f"data{cards} vs data1, tf32 {tf32}"] = (f"data{cards}_{tf32}", f"data1_{tf32}")
    pairs["data1, tf32 on vs off"] = ("data1_on", "data1_off")
    gaps = {f"{k}, {where}": rel_gap(runs[a], runs[b], steps)
            for k, (a, b) in pairs.items()
            for where, steps in (("step 1", 1), (f"{FT_F32_STEPS} steps", None))}
    say("tf32-study", t0, "largest relative gap of the loss and gradient norm, f32: "
        + "; ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return {"gaps": gaps, "runs": runs}


def phase_serve(t0, cards: int, rehearse: bool) -> dict:
    """The Synthesizer over the cards against one card
    (``chip_smoke.serve_over_devices``), then warm ms of the batch on each."""
    from isp_tts_tpu_torch.serving import Synthesizer

    devices = ["cpu"] * cards if rehearse else [f"cuda:{i}" for i in range(cards)]
    one = Synthesizer.from_pretrained(smoke.CKPT, vocoder_path=smoke.VOCODER,
                                      device=devices[0])
    many = Synthesizer.from_pretrained(smoke.CKPT, vocoder_path=smoke.VOCODER, devices=devices)
    r = smoke.serve_over_devices(many, one, SERVE_SENTENCES)
    times = {}
    for name, synth in (("one", one), ("many", many)):
        synth(SERVE_SENTENCES)
        t = time.perf_counter()
        synth(SERVE_SENTENCES)
        times[name] = 1e3 * (time.perf_counter() - t)
    say("serve", t0, f"Synthesizer over {cards} cards against one, {len(SERVE_SENTENCES)} "
        f"sentences, the one card's durations: each card's rows against one card on them mel "
        f"rel {r['errs']['shard']['mel']:.3e}, wave {r['errs']['shard']['wave']:.3e} (bound "
        f"{smoke.SERVE_SHARD_BOUND:.0e}, bit-equal {r['bit_equal']}); the whole batch on one "
        f"card mel rel {r['errs']['whole']['mel']:.3e}, wave {r['errs']['whole']['wave']:.3e} "
        f"(bounds {smoke.SERVE_WHOLE_BOUNDS}); frames {r['frames']}; warm mel batch ms: one "
        f"card {times['one']:.1f}, {cards} cards {times['many']:.1f}")
    return {"errs": {k: {n: float(e) for n, e in v.items()} for k, v in r["errs"].items()},
            "bit_equal": r["bit_equal"], "warm_ms": times}


def recipe_data(t0, work: Path, rehearse: bool) -> dict:
    """The dataset the Synthesizer writes (chip_smoke.py's) and its stats."""
    from isp_tts_tpu_torch.serving import Synthesizer

    dev = "cpu" if rehearse else "cuda:0"
    smoke.DATASET_TRAIN, smoke.DATASET_VALID = ((16, 8) if rehearse
                                                else (RECIPE_TRAIN, RECIPE_VALID))
    synth = Synthesizer.from_pretrained(smoke.CKPT, vocoder_path=smoke.VOCODER, device=dev)
    smoke.say = lambda phase, t, text="": say(phase, t0, text)
    data = smoke.phase_dataset(t0, synth, work / "data")
    del synth
    device = ["--device", "cpu"] if rehearse else []
    proc = subprocess.run([sys.executable, "-m", "isp_tts_tpu_torch.train", "--config-name",
                           smoke.RECIPE, "--compute-stats"] + device + smoke.set_args(data),
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"--compute-stats exited {proc.returncode}: {proc.stderr[-3000:]}")
    return data


#: the axes' recipes over the cards, (recipe, run label, extra settings):
#: fixed collation at core_fast's shape (which 2 seq ranks divide), and
#: core_pp once more with a model axis beside its stage axis
_FIXED = {"collator.max_text_len": smoke.RECIPE_TEXT, "collator.max_mel_len": smoke.RECIPE_MEL}
AXIS_RECIPES = (
    ("acoustic/core_sp", "core_sp", _FIXED),
    ("acoustic/core_pp", "core_pp", _FIXED),
    ("acoustic/core_pp", "core_pp_model2", {**_FIXED, "trainer.mesh_model_axis": 2}),
)


def phase_recipe(t0, work: Path, cards: int, rehearse: bool, data: dict | None = None,
                 recipe: str = smoke.RECIPE, extra: dict | None = None,
                 label: str | None = None) -> dict:
    from isp_tts_tpu_torch.checkpoint import load_checkpoint

    data = data or recipe_data(t0, work, rehearse)
    device = ["--device", "cpu"] if rehearse else []
    label = label or recipe.split("/")[-1]
    settings = {**data, "dataset.stats": str(work / "data" / "stats.json"),
                "trainer.max_steps": RECIPE_STEPS, "trainer.batch_size": smoke.RECIPE_BATCH,
                "trainer.eval_strategy": "no", "trainer.save_strategy": "no",
                "trainer.logging_steps": 1, "trainer.log_with": [], "trainer.label": label,
                "trainer.output_dir": str(work / "runs"), "trainer.progress": False,
                "trainer.resume_from_checkpoint": str(smoke.CKPT), "trainer.warm_start": True,
                "trainer.metric_for_best_model": None}
    if rehearse:  # tiny widths, one row a rank
        settings.update({"trainer.batch_size": cards, "trainer.precision": "fp32",
                         "trainer.steps_per_call": 2, "trainer.resume_from_checkpoint": None,
                         "trainer.warm_start": False, "trainer.max_steps": 2,
                         "model.text_dim": 16, "model.encoder": {
                             "dim": 16, "depth": 1, "transformer_layer": {
                                 "attention": {"heads": 2, "head_dim": 64},
                                 "feed_forward": {"inner_dim": 32}}},
                         "model.decoder": "${model.encoder}",
                         "model.temporal_adaptor.predictor.transformer": {"dim": 16,
                                                                          "depth": 1},
                         "model.temporal_adaptor.embedding.transformer": {"dim": 16,
                                                                          "depth": 1}})
        if recipe == "acoustic/core_pp":  # the stacked decoder: 2 layers for 2 stages
            settings.update({"model.decoder": {
                "dim": 16, "depth": 2, "pipeline": True, "transformer_layer": {
                    "attention": {"heads": 2, "head_dim": 64},
                    "feed_forward": {"inner_dim": 32}}},
                "trainer.pipeline_microbatches": 1})
        if recipe == "acoustic/core_sp":
            settings["model.encoder"]["transformer_layer"]["attention"]["flash"] = "ring"
    settings.update(extra or {})
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(cards), "-m", "isp_tts_tpu_torch.train",
                           "--distributed", "--config-name", recipe] + device
                          + smoke.set_args(settings), cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {recipe} exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    run = work / "runs" / "AcousticModel" / label
    ckpts = sorted(p.name for p in run.glob("*.ckpt"))
    steps = load_checkpoint(run / "checkpoint_last.ckpt")["experiment"]["state"]["global_step"]
    want = settings["trainer.max_steps"]
    if ckpts != ["checkpoint_last.ckpt"] or steps != want:
        raise AssertionError(f"{recipe} over {cards} ranks wrote {ckpts} at step {steps}")
    stacked = {k: v.shape for k, v in load_checkpoint(run / "checkpoint_last.ckpt")[
        "model"]["state"].items() if ".stack." in k}
    if recipe == "acoustic/core_pp" and not stacked:
        raise AssertionError("core_pp's checkpoint holds no stacked tensors")
    layout = [line for line in proc.stderr.splitlines() if "rank 0 of" in line]
    say("recipe", t0, f"torchrun --nproc_per_node {cards} -m isp_tts_tpu_torch.train "
        f"--distributed --config-name {recipe}: exit 0 in {seconds:.1f} s (process, "
        f"start and data pipeline included), {steps} steps, one checkpoint {ckpts}; "
        f"{layout[-1].split('|')[-1].strip() if layout else ''}"
        + (f"; stacked tensors {len(stacked)}, e.g. {next(iter(stacked.items()))}"
           if stacked else ""))
    return {"seconds": seconds, "steps": steps, "stacked_tensors": len(stacked)}


def rehearsal_smoke():
    """chip_smoke.py with its card device names read as the CPU's, for
    ``--rehearse``."""
    import types

    src = (ROOT / "chip_smoke.py").read_text().replace('"cuda"', '"cpu"')
    mod = types.ModuleType("chip_smoke")
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src.replace(".cuda()", ""), mod.__file__, "exec"), mod.__dict__)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--rehearse", action="store_true",
                    help="the control flow on the CPU with gloo at a small size")
    ap.add_argument("--tf32-study", action="store_true",
                    help="on one card: the f32 gap of data 1 against data N, TF32 on and off")
    ap.add_argument("--axes", action="store_true",
                    help="the seq and stage configurations and their recipes only")
    ap.add_argument("--tf32", choices=("on", "off"), help=argparse.SUPPRESS)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--stage", type=int, default=1)
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--stacked", action="store_true")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--config")
    ap.add_argument("--work")
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    import torch

    global smoke
    t0 = time.perf_counter()
    if args.rehearse:
        smoke = rehearsal_smoke()
        smoke.BATCH = 4
    else:
        need = 1 if args.tf32_study else args.cards
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"needs {need} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True)
        print(cards.stdout.strip(), flush=True)
        from isp_tts_tpu_torch.ops import cuda_build

        cuda_build.build_all(smoke.sources())
        say("env", t0, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}; kernels built")
    work = Path(tempfile.mkdtemp(dir=ROOT, prefix="_multi_gpu_"))
    try:
        if args.tf32_study:
            result = {"tf32_study": phase_tf32_study(t0, work, args.cards, args.rehearse)}
        elif args.axes:
            result = {"axes": phase_axes(t0, work, args.rehearse)}
            data = recipe_data(t0, work, args.rehearse)
            result["recipes"] = {label: phase_recipe(t0, work, args.cards, args.rehearse, data,
                                                     name, extra, label)
                                 for name, label, extra in AXIS_RECIPES}
        else:
            result = {"finetune": phase_finetune(t0, work, args.cards, args.rehearse),
                      "serve": phase_serve(t0, args.cards, args.rehearse),
                      "recipe": phase_recipe(t0, work, args.cards, args.rehearse)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("done", t0, "every phase passed")
    result["device"] = ("cpu (rehearsal, not a measurement)" if args.rehearse else
                        {"kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Whether the fine-tuning step repeats itself bit for bit on one NVIDIA
card, and which parameters move when it does not.

    python3 tools/torch_step_repeat.py [--runs 5] [--steps 2] [--recipe]

Each run loads the committed checkpoint afresh and takes ``--steps`` steps
of its own trainer settings (bf16) on the smoke's batch of 32 (text 48 x
mel 320), with the same generator seed (dropout masks and flow noise), on
the kernel path, as ``chip_smoke.py``'s fine-tuning phase does. Every run's
parameters are held against the first run's: the tensors that differ, by
how much. The runs are made with cuDNN free to pick any algorithm (the
process's default) and again with cuDNN's deterministic algorithms; then
one step under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` names the operations that have no deterministic
implementation. With ``--recipe`` each run is instead the smoke's
``acoustic/core_fast`` run (16 bf16 steps, B 32 x 192 x 896, the data
pipeline and the front end on the card) on a dataset that the committed
checkpoints synthesize, as its ``resume`` phase makes its runs; the losses
are held against the first run's too (``--modes``: cuDNN free, then
deterministic). Then a core_fast trainer's gradients on its first batch,
40 calls from the same weights and seed: the tensors that differ from the
first call's, among them the gradients of the text embedding's output and
of the encoder's first layer's input and sublayer outputs; and the text
embedding's backward alone on that batch's tokens. The card's name and
power limit are printed first.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def run(experiment, batch, steps: int) -> dict:
    """The parameters after ``steps`` steps from the checkpoint (seed 7)."""
    trainer = c.make_trainer(experiment, False, 7)
    trainer.train([batch], steps)
    return params(trainer.model)


def params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def compare(label: str, first: dict, other: dict) -> None:
    """Print the tensors of ``other`` that differ from ``first``'s."""
    import torch

    differ = {n: (first[n].float() - other[n].float()).abs().max().item()
              for n in first if not torch.equal(first[n], other[n])}
    print(f"[repeat] {label}: {len(differ)} of {len(first)} tensors differ"
          + "".join(f"; {n} {d:.3e}" for n, d in sorted(differ.items())), flush=True)


def recipe(args, t0) -> None:
    """The smoke's core_fast run ``--runs`` times in each cuDNN mode."""
    import torch

    from isp_tts_tpu_torch.serving import Synthesizer

    work = Path(tempfile.mkdtemp(dir=ROOT, prefix="_smoke_repeat_"))
    try:
        synth = Synthesizer.from_pretrained(c.CKPT, vocoder_path=c.VOCODER)
        data = c.phase_dataset(t0, synth, work / "data")
        del synth
        data = c.phase_stats(t0, data)
        for deterministic in (False, True)[:args.modes]:
            torch.backends.cudnn.deterministic = deterministic
            runs = []
            for i in range(args.runs):
                trainer, _ = c.recipe_trainer(data, work / f"run_{deterministic}_{i}",
                                              save_strategy="no")
                trainer.train()
                runs.append((c.step_losses(trainer), params(trainer.model)))
                del trainer
                torch.cuda.empty_cache()
            for i, (loss, state) in enumerate(runs[1:], 2):
                gap = max(abs(loss[s] - runs[0][0][s]) for s in loss)
                compare(f"core_fast, cuDNN deterministic {deterministic}, run {i} against run "
                        f"1 (loss max gap {gap:.3e})", runs[0][1], state)
        recipe_grads(data, work)
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(work, ignore_errors=True)


def recipe_grads(data: dict, work: Path, repeats: int = 40) -> None:
    """A core_fast trainer's gradients on its first batch, ``repeats``
    times from the same weights and generator seed: the parameters whose
    gradients differ from the first call's, and where the gradient first
    differs below the encoder's first layer (the gradients leaving and
    reaching the text embedding, the first layer's input and the outputs of
    its norms, projections and feed-forward); then the text embedding's
    backward alone (PyTorch's) on that batch's tokens and the first call's
    output gradient."""
    import torch

    trainer, _ = c.recipe_trainer(data, work / "grads", save_strategy="no")
    batch = next(iter(trainer.train_loader))
    model, seen = trainer.model, {}
    layer = model.encoder.layers[0]
    watched = {"text_embedding": model.text_embedding, "layer0.attention_norm":
               layer.attention_norm, "layer0.to_q": layer.attention.to_q,
               "layer0.to_kv": layer.attention.to_kv, "layer0.to_out": layer.attention.to_out,
               "layer0.feed_forward_norm": layer.feed_forward_norm,
               "layer0.feed_forward": layer.feed_forward}

    def keep(name):
        def store(g):
            seen[name] = g.detach().clone()
        return store

    def watch_output(name):
        def hook(module, args, out):
            if out.requires_grad:
                out.register_hook(keep(f"{name} out-grad"))
        return hook

    def watch_input(module, args):
        if args[0].requires_grad:
            args[0].register_hook(keep("layer0 in-grad"))

    for name, module in watched.items():
        module.register_forward_hook(watch_output(name))
    layer.register_forward_pre_hook(watch_input)
    first, differ = None, {}
    for r in range(repeats):
        seen.clear()
        trainer.compute_gradients(batch)
        now = {**{n: p.grad.detach().clone() for n, p in model.named_parameters()
                  if p.grad is not None}, **seen}
        if first is None:
            first = now
            continue
        for n in first:
            if not torch.equal(first[n], now[n]):
                d = (first[n].float() - now[n].float()).abs().max().item()
                count, most = differ.get(n, (0, 0.0))
                differ[n] = (count + 1, max(most, d))
    print(f"[repeat] core_fast gradients on one batch, {repeats} calls: {len(differ)} tensors "
          "differ from the first call's" + "".join(
              f"; {n} in {k} calls (max {d:.3e})" for n, (k, d) in sorted(differ.items())),
          flush=True)
    tokens = torch.as_tensor(batch["text_vector"]).to(model.text_embedding.weight.device)
    g = first["text_embedding out-grad"]
    w = model.text_embedding.weight.detach().clone().requires_grad_(True)
    ref, count = None, 0
    for _ in range(repeats):
        torch.nn.functional.embedding(tokens, w).backward(g)
        if ref is None:
            ref = w.grad.clone()
        elif not torch.equal(ref, w.grad):
            count += 1
        w.grad = None
    print(f"[repeat] nn.functional.embedding backward alone, tokens {tuple(tokens.shape)} "
          f"({tokens.numel()} indices, {int((tokens == 0).sum())} of them 0): {count} of "
          f"{repeats - 1} calls differ from the first", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--recipe", action="store_true")
    ap.add_argument("--modes", type=int, default=2, choices=(0, 1, 2),
                    help="--recipe: whole runs with cuDNN free (1) and deterministic (2)")
    args = ap.parse_args()
    import torch

    from isp_tts_tpu_torch.serving import Synthesizer

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_repeat: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    t0 = time.perf_counter()
    c.phase_env(t0)
    c.phase_build(t0)
    if args.recipe:
        recipe(args, t0)
        print(f"[repeat] {time.perf_counter() - t0:.1f}s", flush=True)
        return 0
    synth = Synthesizer.from_pretrained(c.CKPT)
    experiment, batch, _ = c.phase_batch(t0, synth)
    del synth
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        first = run(experiment, batch, args.steps)
        for i in range(1, args.runs):
            compare(f"cuDNN deterministic {deterministic}, run {i + 1} against run 1 after "
                    f"{args.steps} steps", first, run(experiment, batch, args.steps))
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(experiment, batch, 1)
    torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"[repeat] operations without a deterministic implementation in one step: "
          f"{len(ops)}" + "".join(f"\n[repeat]   {m}" for m in ops), flush=True)
    print(f"[repeat] {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

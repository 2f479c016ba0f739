#!/usr/bin/env python3
"""Host time of one fine-tuning step on one NVIDIA card, for this checkout
and another side by side, or with ``--serve`` of one live request.

    python3 tools/torch_step_time.py [--parent DIR] [--steps 30] [--rounds 2]
                                     [--serve]

Each checkout is timed in a process of its own through its own
``chip_smoke.py`` (``phase_env``, ``phase_build``, ``phase_batch`` and
``make_trainer``): the committed checkpoint fine-tuned on the smoke's
batch of 32 (text 48 x mel 320, bf16) with its own trainer settings, the
one-KV-head model and the multi-KV-head one. It reads, over steps 6 to
``--steps``:
- ``step``: ``trainer.train([batch], 1)``, host clock, synced (its
  metrics come back as floats), as the smoke's fine-tuning phase reads it;
- ``grads`` and ``update``: forward and backward (``compute_gradients``)
  and the optimizer's step, each synced, over as many more steps;
- ``update_host``: the host time of the optimizer's call alone, unsynced.
With ``--serve`` it reads instead, as median and min over requests 6 to
``--steps``, a warm live request of the smoke's first sentence through the
committed checkpoint and vocoder at batch 1, text bucket 128 and frame
budget 1024, host clock (numpy on return): ``audio``
(``Synthesizer.synthesize_audio``) and ``mel`` (``Synthesizer.__call__``),
the two taken in turn.
The parent's ``compute_gradients`` clips the gradients, this checkout's
optimizer does. ``--parent DIR`` is e.g. ``git archive HEAD | tar -x -C
_scratch/parent`` (its kernels are built there). The rounds run the
checkouts in turn, the second round in reverse order (parent, change,
change, parent with two rounds). The card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def serve_times(c, requests: int) -> dict:
    """{"audio" | "mel": [median, min] ms of a warm live request}."""
    from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig

    synth = Synthesizer.from_pretrained(c.CKPT, SynthesizerConfig(
        text_buckets=(128,), frame_budgets=(1024,), batch_buckets=(1,)),
        vocoder_path=c.VOCODER)
    runs = {"audio": lambda: synth.synthesize_audio(c.SENTENCES[0]),
            "mel": lambda: synth(c.SENTENCES[0])}
    times = {name: [] for name in runs}
    for _ in range(requests):
        for name, run in runs.items():
            t = time.perf_counter()
            run()  # numpy on return: the device is done
            times[name].append(1e3 * (time.perf_counter() - t))
    return {name: [float(np.median(v[5:])), float(np.min(v[5:]))]
            for name, v in times.items()}


def child(root: Path, steps: int, serve: bool) -> dict:
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as c
    from isp_tts_tpu_torch.serving import Synthesizer

    # an archive of the other checkout's package, tools and smoke alone
    # reads the checkpoints of this one
    for name in ("CKPT", "VOCODER"):
        if not getattr(c, name).exists():
            setattr(c, name, ROOT / getattr(c, name).relative_to(root))
    t0 = time.perf_counter()
    c.phase_env(t0)
    c.phase_build(t0)
    if serve:
        return {"serve": serve_times(c, steps)}
    synth = Synthesizer.from_pretrained(c.CKPT)
    experiment, batch, _ = c.phase_batch(t0, synth)
    del synth
    out = {}
    for mha in (False, True):
        trainer = c.make_trainer(experiment, False, 7, mha=mha)
        takes_norm = "grad_norm" in inspect.signature(trainer.optimizer.step).parameters
        step, grads, update, host = [], [], [], []
        for _ in range(steps):
            t = time.perf_counter()
            trainer.train([batch], 1)
            step.append(1e3 * (time.perf_counter() - t))
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.compute_gradients(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if takes_norm:
                trainer.optimizer.step(trainer._grad_norm)
            else:
                trainer.optimizer.step()
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            grads.append(1e3 * (t1 - t))
            update.append(1e3 * (t3 - t1))
            host.append(1e3 * (t2 - t1))
        out["mha" if mha else "mqa"] = {
            name: [float(np.mean(v[5:])), float(np.min(v[5:]))]
            for name, v in (("step", step), ("grads", grads), ("update", update),
                            ("update_host", host))}
        del trainer
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--serve", action="store_true",
                    help="time a warm live request (audio and mel) instead")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print("RESULT " + json.dumps(child(args.child.resolve(), args.steps, args.serve)),
              flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    roots = [("change", ROOT)] + ([("parent", args.parent.resolve())] if args.parent else [])
    order = []
    for r in range(args.rounds):
        order += roots[::-1] if r % 2 == 0 else roots
    for label, root in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(root), "--steps",
                               str(args.steps)] + ["--serve"] * args.serve, cwd=root,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        result = json.loads(lines[-1][7:])
        for model, times in result.items():
            unit = "median/min over requests" if model == "serve" else "mean/min over steps"
            print(f"{label} {model}: ms {unit} 6-{args.steps}: " + "; ".join(
                f"{name} {m:.2f}/{lo:.2f}" for name, (m, lo) in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

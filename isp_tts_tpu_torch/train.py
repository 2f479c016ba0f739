"""Training CLI (counterpart of ``isp_tts_tpu/train.py``)::

    python -m isp_tts_tpu_torch.train --config-root recipes \\
        --config-name acoustic/core_fast --set dataset.root=/data/ljs [--device cuda]

``--set a.b.c=<yaml>`` overrides a recipe key (the value read as YAML,
raw text where it is not YAML); ``--compute-stats`` scans the training
split's pitch and energy, writes ``stats.json`` to the dataset root and
exits. Runs on the card unless ``--device`` names another; there is no
fallback.

Several cards, one process each (the JAX package's one process over
every device of a host becomes)::

    torchrun --nproc_per_node N -m isp_tts_tpu_torch.train --distributed \
        --config-name acoustic/core_fast [--set trainer.mesh_model_axis=2]

``--distributed`` reads torchrun's environment, starts NCCL on
``cuda:LOCAL_RANK`` (gloo with ``--device cpu``) and trains the data ×
model × seq × stage mesh of the recipe's ``trainer.mesh_model_axis``,
``mesh_seq_axis`` and ``mesh_pipeline_axis`` (``acoustic/core_sp`` rings
the attention over 2 seq ranks, ``acoustic/core_pp`` runs the stacked
decoder over 2 stages); rank 0 writes the checkpoints (a stacked layer
stack's global tensors, gathered over the stages).
"""

from __future__ import annotations

import argparse
import logging

from .config import parse_overrides


def main(argv=None):
    parser = argparse.ArgumentParser(description="isp_tts_tpu_torch trainer")
    parser.add_argument("--config-root", default="recipes")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="KEY=VALUE", help="config overrides (dot paths)")
    parser.add_argument("--compute-stats", action="store_true",
                        help="compute dataset pitch/energy stats and exit")
    parser.add_argument("--device", default="cuda",
                        help="device to train on (default: cuda; there is no fallback)")
    parser.add_argument("--distributed", action="store_true",
                        help="one process of a torchrun group: NCCL on cuda:LOCAL_RANK "
                             "(gloo with --device cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    device = args.device
    if args.distributed:
        import torch

        from .parallel.mesh import init_distributed

        device = init_distributed("nccl" if torch.device(device).type == "cuda" else "gloo")
    try:
        _run(args, device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, device) -> None:
    from .parallel.mesh import barrier, process_local_mesh_info
    from .training.experiment import ExperimentModules

    modules = ExperimentModules(args.config_name, args.config_root,
                                overrides=parse_overrides(args.overrides), device=device)
    if args.compute_stats:
        if process_local_mesh_info()[1] == 0:  # one rank writes stats.json
            stats = modules.build_dataset("train").compute_stats(save_stats=True)
            print(stats.to_dict())
        barrier("compute_stats")
        return
    modules.init_modules()
    modules.build_trainer().train()


if __name__ == "__main__":
    main()

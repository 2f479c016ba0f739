"""Training CLI (counterpart of ``isp_tts_tpu/train.py``)::

    python -m isp_tts_tpu_torch.train --config-root recipes \\
        --config-name acoustic/core_fast --set dataset.root=/data/ljs [--device cuda]

``--set a.b.c=<yaml>`` overrides a recipe key (the value read as YAML,
raw text where it is not YAML); ``--compute-stats`` scans the training
split's pitch and energy, writes ``stats.json`` to the dataset root and
exits. Runs on the card unless ``--device`` names another; there is no
fallback.
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
                        help="multi-process training (not ported)")
    args = parser.parse_args(argv)
    if args.distributed:
        raise NotImplementedError("multi-GPU training is not ported (ROADMAP Queue 1 item 5)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s")

    from .training.experiment import ExperimentModules

    modules = ExperimentModules(args.config_name, args.config_root,
                                overrides=parse_overrides(args.overrides), device=args.device)
    if args.compute_stats:
        stats = modules.build_dataset("train").compute_stats(save_stats=True)
        print(stats.to_dict())
        return
    modules.init_modules()
    modules.build_trainer().train()


if __name__ == "__main__":
    main()

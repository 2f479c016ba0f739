"""The port imports torch, numpy and the standard library only, builds its
kernels with plain nvcc, and adds no large files to the tree."""

import json
import subprocess
import sys
from pathlib import Path

from isp_tts_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "isp_tts_tpu_torch"
BLOCKED = ["jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "omegaconf",
           "matplotlib", "isp_tts_tpu"]

_CHILD = """
import importlib, importlib.abc, json, pkgutil, sys
blocked = set(json.loads(sys.argv[1]))

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(f"{name} is not available to the port")
        return None

sys.meta_path.insert(0, Refuse())
import isp_tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(isp_tts_tpu_torch.__path__,
                                               "isp_tts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
print(json.dumps({"modules": names, "blocked_loaded": loaded}))
"""


def _port_sources():
    files = [p for p in PORT.rglob("*") if p.is_file()
             and "_build" not in p.parts and "__pycache__" not in p.parts]
    return files + [ROOT / "chip_smoke.py"]


def test_port_and_chip_smoke_import_without_jax_flax_msgpack_yaml():
    """Every module of the port, and the smoke, imports with JAX, flax,
    optax, msgpack, YAML and matplotlib refused."""
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(BLOCKED)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["blocked_loaded"] == []
    for name in ("checkpoint", "serving", "ops.flash_attention", "ops.cuda_build",
                 "ops.mas", "ops.ctc", "models.acoustic.model", "nn.attention",
                 "training.trainer_config", "config",
                 "models.acoustic.aligner", "models.acoustic.loss",
                 "training.optimizers", "training.trainer", "data.text.table",
                 "serving_server", "synthesize", "models.vocoder", "models.vocoder.model",
                 "ops.vocoder", "ops.audio", "data.audio", "config.loader", "config.yamlio",
                 "config.registry", "ops.pitch", "ops.frontend", "data.dataset",
                 "data.collator", "data.loader", "data.metadata", "data.stats",
                 "data.providers", "training.callbacks", "training.experiment",
                 "models.acoustic.evaluator", "utils.plotting", "train",
                 "data.text.phonemes", "data.text.word_level", "data.text.processor",
                 "native", "data.vocoder", "models.vocoder.discriminator",
                 "models.vocoder.loss", "models.vocoder.evaluator", "training.gan_trainer"):
        assert f"isp_tts_tpu_torch.{name}" in out["modules"]


def test_no_cpp_extension_and_plain_nvcc_build(monkeypatch):
    for path in _port_sources():
        if path.suffix in (".py", ".cu", ".cuh", ".h"):
            assert "cpp_extension" not in path.read_text(), path
            assert "ninja" not in path.read_text(), path
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "/usr/local/cuda/bin/nvcc")
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    assert sources == ["ctc", "flash_bwd", "flash_fwd", "mas", "mqa_bwd", "mqa_fwd"]
    headers = sorted(p.name for p in cuda_build.CSRC.glob("*.cuh"))
    assert headers == ["attention_bwd.cuh", "attention_common.cuh", "attention_fwd.cuh",
                       "attention_mma.cuh", "dp_common.cuh"]
    for name in headers + [f"{s}.cu" for s in sources]:
        text = (cuda_build.CSRC / name).read_text()
        assert "#include <torch" not in text and "Python.h" not in text, name
    # an edited shared header gives every source a new library name
    before = cuda_build.library_path("flash_fwd")
    monkeypatch.setattr(cuda_build.Path, "read_bytes",
                        lambda self, real=cuda_build.Path.read_bytes:
                        real(self) + (b"//" if self.suffix == ".cuh" else b""))
    assert cuda_build.library_path("flash_fwd") != before
    monkeypatch.undo()
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "/usr/local/cuda/bin/nvcc")
    for name in sources:
        text = (cuda_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "#include <torch" not in text, name
        assert "Python.h" not in text, name
        cmd = cuda_build.nvcc_command(cuda_build.CSRC / f"{name}.cu", Path("/x/lib.so"))
        assert Path(cmd[0]).name == "nvcc"
        for flag in ("-O3", "-arch=sm_90a", "-shared", "-fPIC"):
            assert flag in cmd
        # no torch or python headers
        assert not any(part.startswith(("-I", "-L", "-l")) for part in cmd)
    assert cuda_build.BUILD_DIR == PORT / "_build"
    assert "isp_tts_tpu_torch/_build/" in (ROOT / ".gitignore").read_text().split()


def test_port_files_are_small_and_not_binaries():
    new_files = _port_sources() + sorted((ROOT / "tests").glob("test_torch_port_*.py"))
    new_files += [ROOT / "tests" / "torch_port_common.py", ROOT / "PERF.md"]
    for path in new_files:
        if path.exists():
            assert path.stat().st_size < 1 << 20, path
            assert path.suffix not in (".so", ".o", ".ckpt", ".pt", ".npy", ".npz"), path

"""The port's recipe loader against the JAX package's, on the CPU.

- Every file under ``recipes/`` loads to the same dict through both
  loaders (base chains, ``_disable_`` pruning, interpolation; the date
  resolvers pinned in both), unresolved and resolved.
- ``--set`` values parse as ``parse_overrides`` parses them (PyYAML's
  ``safe_load``, YAML 1.1 scalars), on a table of values.
- The port's YAML writer reads back to the same config here and through
  ``yaml.safe_load``.
Exact equality throughout (values and types).
"""

import math
from pathlib import Path

import pytest
import yaml

from isp_tts_tpu.config import loader as jloader
from isp_tts_tpu.train import parse_overrides as jax_parse_overrides
from isp_tts_tpu_torch.config import loader as ploader
from isp_tts_tpu_torch.config import parse_overrides
from isp_tts_tpu_torch.config.yamlio import YAMLError, dump, loads

RECIPES = sorted(str(p.relative_to("recipes")) for p in Path("recipes").rglob("*.yaml"))


@pytest.fixture(autouse=True)
def pinned_dates():
    """Both loaders' date resolvers return a fixed day."""
    saved = {name: (jloader._RESOLVERS[name], ploader._RESOLVERS[name])
             for name in ("date", "version")}
    for mod in (jloader, ploader):
        mod.register_resolver("date", lambda: "2026-01-02")
        mod.register_resolver("version", lambda: "v260102")
    yield
    for name, (j, p) in saved.items():
        jloader.register_resolver(name, j)
        ploader.register_resolver(name, p)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", RECIPES)
@pytest.mark.parametrize("resolve", [False, True])
def test_recipe_loads_as_jax_loads_it(name, resolve):
    """A recipe that is only a base (``default.yaml`` points at a model it
    does not name) fails to resolve in both, with the same error."""
    try:
        ref = jloader.load_recipe(name, "recipes", resolve=resolve)
    except KeyError as e:
        with pytest.raises(KeyError, match=str(e.args[0]).replace("$", r"\$")):
            ploader.load_recipe(name, "recipes", resolve=resolve)
        return
    got = ploader.load_recipe(name, "recipes", resolve=resolve)
    assert _same(got, ref)


def test_recipe_with_overrides_and_interpolation():
    over = {"dataset": {"root": "/data", "audio": {"sample_rate": 16000}},
            "trainer": {"label": "${index:run,${trainer.seed}}", "_disable_x": 1},
            "collator": {"_disable_": True}}
    ref = jloader.load_recipe("acoustic/core_fast", "recipes", overrides=over)
    got = ploader.load_recipe("acoustic/core_fast", "recipes", overrides=over)
    assert _same(got, ref)
    assert got["dataset"]["mel_scale"]["sample_rate"] == 16000
    assert "collator" not in got and got["trainer"]["label"] == "run-42"


VALUES = ["2e-4", "1.0e-4", "1.0e4", "1e3", "3.", ".5", "-3.5", "+12", "0", "00", "017",
          "0o17", "0x1F", "0b101", "1_000", "1:30", "1:30.5", ".inf", "-.Inf", ".nan",
          "yes", "No", "on", "OFF", "true", "True", "TRUE", "tRue", "~", "null", "",
          "[1, 2]", "{a: 1}", "{a: 1, b: [x, 'y z'], c: {d: null}}", "[a: 1, b]",
          "[1, [2, 3], {a: b}]", "[]", "{}", "[1,2,]", "hello world", "abc # comment",
          "${model.encoder}", "'quoted'", '"dq \\u00e9 \\n"', "x:y", "a: b", "a: [1, 2]",
          "2026-10-17", "[1, 2", "a: b: c", "[1, , 2]", "- 1\n- 2", "a:\n  b: 1\n  c: [2]"]


@pytest.mark.parametrize("raw", VALUES)
def test_set_values_parse_as_jax_parses_them(raw):
    ref = jax_parse_overrides([f"trainer.x={raw}"])
    got = parse_overrides([f"trainer.x={raw}"])
    assert _same(got, ref)


def test_reader_refuses_what_is_outside_the_subset():
    for text in ("&a 1", "*a", "!!str 1", "|\n  text", "a: [1, 2"):
        with pytest.raises(YAMLError):
            loads(text)


@pytest.mark.parametrize("name", RECIPES)
def test_writer_round_trips_through_both_readers(name):
    cfg = ploader.load_recipe(name, "recipes", resolve=False)
    cfg["extra"] = {"floats": [1e-5, 2e-4, 1.0, 1e20, -0.5, 5e-324], "s": ["yes", "1.0", "",
                    "é", "a: b", "#x"], "n": None, "b": [True, False], "i": [0, -7, 2**40]}
    text = dump(cfg)
    assert _same(loads(text), cfg)
    assert _same(yaml.safe_load(text), cfg)

"""The phonemizer text path of the port against the JAX package, on the CPU.

The port's copies of ``test_espeak_golden.py``, ``test_phonemes.py`` and
``test_word_level.py``: the same backends (the golden espeak-ng corpus
``tests/fixtures/espeak_golden.json``, the toy G2P, the context-sensitive
fake conversion; no espeak-ng is installed), the same expected groups and
strings, and each output equal to the JAX package's. Masking draws from
Python's ``random`` (or the ``rng`` given) in the same order, so the same
seed keeps the same groups as graphemes; ``TextProvider`` ids with
``mask_phonemes`` equal JAX's under one seed, per word and per utterance.
"""

import logging
import random

import numpy as np
import pytest

from isp_tts_tpu.data.providers import TextProvider as JTextProvider
from isp_tts_tpu.data.providers import TextProviderConfig as JTextProviderConfig
from isp_tts_tpu.data.text.phonemes import Phonemizer as JPhonemizer
from isp_tts_tpu.data.text.word_level import align_word_groups as jalign
from isp_tts_tpu_torch.data.providers import TextProvider, TextProviderConfig
from isp_tts_tpu_torch.data.text.phonemes import Phonemizer
from isp_tts_tpu_torch.data.text.processor import TextProcessor
from isp_tts_tpu_torch.data.text.word_level import WordAlignmentError, align_word_groups
from test_espeak_golden import GoldenBackend
from test_phonemes import FakeBackend
from test_word_level import ContextFakeBackend, fake_conv

IPA_CHARSET = ["<pad>", "</s>", "#punct", "#en", "#ipa_ph"]


def both(backend_cls, *args):
    return Phonemizer(backend=backend_cls(*args)), JPhonemizer(backend=backend_cls(*args))


# -- test_word_level.py ----------------------------------------------------------

WORD_LEVEL = [  # text, expected groups, expected conv groups (None: invariants only)
    ("look on the internet", ["look", "on the", "internet"], ["lʊk", "ɔnðɪ", "ɪntɚnɛt"]),
    ("cannot stop", ["cannot", "stop"], ["kæn nɑt", "stɑp"]),
    ("stop it now.", ["stop", "it", "now."], ["stɑp", "ɪt", "naʊ."]),
    ("look uh stop", None, None),
    ("look on the internet cannot stop it up now.", None, None),
]


@pytest.mark.parametrize("text,groups,conv_groups", WORD_LEVEL)
def test_word_groups_match_jax(text, groups, conv_groups):
    got = align_word_groups(text, fake_conv)
    assert got == jalign(text, fake_conv)
    g, conv, cg = got
    assert " ".join(g) == text
    assert " ".join(x for x in cg if x is not None) == conv
    if groups is not None:
        assert (g, cg) == (groups, conv_groups)
    if "on the" in text:
        assert cg[g.index("on the")] == "ɔnðɪ" and fake_conv("on the") == "ɔnðə"


def test_inconsistent_conversion_raises():
    calls = {"n": 0}

    def unstable(text: str) -> str:
        calls["n"] += 1
        return " ".join(w + str(calls["n"]) for w in text.split(" "))

    with pytest.raises(WordAlignmentError):
        align_word_groups("a b c d e f g h i j", unstable)


def test_phonemizer_masking_uses_groups():
    ph, jph = both(ContextFakeBackend)
    text = "look on the internet"
    assert ph.phonemize_words(text) == jph.phonemize_words(text)
    assert ("on the", "ɔnðɪ") in ph.phonemize_words(text)
    assert ph(text, mask_phonemes=1e-12) == "lʊk ɔnðɪ ɪntɚnɛt"
    assert ph(text, mask_phonemes=1.0) == text


# -- test_phonemes.py -------------------------------------------------------------

def test_toy_backend_phonemize_and_mask_extremes():
    ph, jph = both(FakeBackend)
    assert ph.phonemize_text("hello world") == "OLEH DLROW"
    for mask, want in ((1.0, "hello world"), (1e-12, "OLEH DLROW"), (False, "OLEH DLROW")):
        assert ph("hello world", mask_phonemes=mask) == want
        assert jph("hello world", mask_phonemes=mask) == want


def test_toy_backend_merged_words_group_search():
    ph, jph = both(FakeBackend, True)
    pairs = ph.phonemize_words("hello world go")
    assert pairs == jph.phonemize_words("hello world go")
    assert pairs == [("hello world", "OLEHDLROW"), ("go", "OG")]
    assert ph("hello world go", mask_phonemes=1.0) == "hello world go"
    assert ph("hello world go", mask_phonemes=1e-12) == "OLEHDLROW OG"


@pytest.mark.parametrize("backend,text", [(FakeBackend, "hello world go"),
                                          (GoldenBackend, "i read it on the internet")])
def test_masking_mixture_draws_as_jax(backend, text):
    """The same seed keeps the same groups as graphemes in both packages,
    from an ``rng`` and from the ``random`` module."""
    ph, jph = both(backend)
    ours = [ph(text, mask_phonemes=0.5, rng=r) for r in [random.Random(0)] for _ in range(32)]
    ref = [jph(text, mask_phonemes=0.5, rng=r) for r in [random.Random(0)] for _ in range(32)]
    assert ours == ref
    assert len(set(ours)) > 2  # mixtures occur
    random.seed(7)
    ours = [ph(text, mask_phonemes=0.5) for _ in range(16)]
    random.seed(7)
    assert ours == [jph(text, mask_phonemes=0.5) for _ in range(16)]


# -- test_espeak_golden.py -------------------------------------------------------

GOLDEN = [
    ("on the internet", [("on the", "ɔnðɪ"), ("internet", "ˈɪntɚnˌɛt")]),
    ("i read it on the internet", [("i", "ˈaɪ"), ("read", "ɹˈɛd"), ("it", "ɪt"),
                                   ("on the", "ɔnðɪ"), ("internet", "ˈɪntɚnˌɛt")]),
    ("wait - stop", [("wait", "wˈeɪt"), ("-", None), ("stop", "stˈɑːp")]),
    ("the moonlight", [("the", "ðə"), ("moonlight", "mˈuːn lˈaɪt")]),
]


@pytest.mark.parametrize("text,pairs", GOLDEN)
def test_golden_groups_match_jax(text, pairs):
    ph, jph = both(GoldenBackend)
    assert ph.phonemize_words(text) == pairs == jph.phonemize_words(text)
    for mask in (False, 1.0):
        assert ph(text, mask_phonemes=mask) == jph(text, mask_phonemes=mask)


def test_golden_dropped_token_and_group_atomic_masking():
    ph, _ = both(GoldenBackend)
    assert ph("wait - stop", mask_phonemes=False) == "wˈeɪt stˈɑːp"
    assert ph("wait - stop", mask_phonemes=1.0) == "wait - stop"
    rng = random.Random(3)
    outs = {ph("i read it on the internet", mask_phonemes=0.5, rng=rng) for _ in range(64)}
    assert any("ɔnðɪ" in o for o in outs) and any("on the" in o for o in outs)
    assert not any(("on" in o.split(" ") and "ɔnðɪ" in o) for o in outs)


def test_text_provider_encodes_golden_ipa(caplog):
    provider = TextProvider.from_config(TextProviderConfig(charset=IPA_CHARSET, phonemizer=True),
                                        phonemizer_backend=GoldenBackend())
    jprovider = JTextProvider(JTextProviderConfig(charset=IPA_CHARSET))
    jprovider.text_processor.phonemizer = JPhonemizer(backend=GoldenBackend())
    with caplog.at_level(logging.WARNING):
        ids = provider("I read it on the internet.")
    assert not [r for r in caplog.records if "unknown" in r.message.lower()]
    np.testing.assert_array_equal(ids, jprovider("I read it on the internet.").vector)
    decoded = jprovider.coding_table.vector_to_text(ids)
    assert "ɔnðɪ" in decoded and "ɹˈɛd" in decoded and ids.min() >= 0


@pytest.mark.parametrize("word_level", [True, False])
def test_text_provider_masked_ids_match_jax(word_level):
    """Per-word and per-utterance masking through both providers, with the
    context-sensitive backend (the golden corpus lacks the punctuated words
    the cleaners produce)."""
    cfg = dict(charset=IPA_CHARSET, phonemizer=False, mask_phonemes=0.5,
               word_level_prob=word_level)
    provider = TextProvider.from_config(TextProviderConfig(**cfg),
                                        phonemizer_backend=ContextFakeBackend())
    jprovider = JTextProvider(JTextProviderConfig(**cfg))
    jprovider.text_processor.phonemizer = JPhonemizer(backend=ContextFakeBackend())
    texts = ["Look on the internet", "Cannot stop it up now", "Look uh stop"] * 6
    random.seed(11)
    ours = [provider(t) for t in texts]
    random.seed(11)
    ref = [jprovider(t).vector for t in texts]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert len({tuple(a) for a in ours[::3]}) > 1  # the masks differ across draws


def test_processor_phonemizes_after_the_cleaners():
    proc = TextProcessor(phonemizer_backend=GoldenBackend())
    assert proc("Wait - stop") == "wˈeɪt stˈɑːp"
    assert TextProcessor()("Wait - stop") == "wait - stop"

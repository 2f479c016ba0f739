"""Grapheme-to-phoneme conversion with word-level grapheme/phoneme mixing.

Counterpart of ``isp_tts_tpu/data/text/phonemes.py``. The backend converts
whole utterances; ``mask_phonemes`` keeps a random subset of word groups
as graphemes (phoneme masking). The backend is injected: any object with
``phonemize([text], separator=..., strip=True) -> [str]`` whose words are
joined by ``|``. Only when none is given is espeak-ng's backend of the
``phonemizer`` package imported, in the constructor.

The masking draws from Python's ``random`` module (or the ``rng`` passed),
one ``random()`` per group in order, as the JAX package draws: the same
seed keeps the same groups as graphemes in both packages.
"""

from __future__ import annotations

import logging
import random

from .word_level import WordAlignmentError, align_word_groups

logger = logging.getLogger("isp_tts_tpu_torch")


class Phonemizer:
    def __init__(self, language: str = "en-us", preserve_punctuation: bool = True,
                 with_stress: bool = True, backend=None):
        if backend is not None:
            self._backend = backend
            self._separator = None
            return
        try:
            from phonemizer.backend import EspeakBackend
            from phonemizer.separator import Separator
        except ImportError as e:
            raise ImportError(
                "phoneme pipelines need the `phonemizer` package with espeak-ng, or a "
                "backend passed as Phonemizer(backend=...)") from e
        self._separator = Separator(phone="", word="|")
        self._backend = EspeakBackend(language, preserve_punctuation=preserve_punctuation,
                                      with_stress=with_stress,
                                      language_switch="remove-flags")

    def _phonemize_raw(self, text: str) -> str:
        return self._backend.phonemize([text], separator=self._separator, strip=True)[0]

    def phonemize_text(self, text: str) -> str:
        return self._phonemize_raw(text).replace("|", " ")

    def phonemize_words(self, text: str) -> list[tuple[str, str | None]]:
        """[(text group, phoneme group)] pairs covering the utterance; a
        phoneme group of None converts to nothing. Word counts that line up
        zip directly; otherwise the group search over the whole-string
        conversion; per-word conversion when that search fails."""
        words = text.split(" ")
        phon_words = [w for w in self._phonemize_raw(text).split("|") if w != ""]
        if len(phon_words) == len(words):
            return list(zip(words, phon_words))
        try:
            text_groups, _, conv_groups = align_word_groups(text, self.phonemize_text)
            return list(zip(text_groups, conv_groups))
        except (WordAlignmentError, AssertionError):
            logger.debug("word-level group search failed for %r; per-word fallback", text)
        per_word = [self._phonemize_raw(w).replace("|", " ") for w in words]
        return list(zip(words, per_word))

    def __call__(self, text: str, mask_phonemes: bool | float = False,
                 rng: random.Random | None = None) -> str:
        """Phonemize; with probability ``mask_phonemes`` a group keeps its
        graphemes instead of its phonemes."""
        rng = rng or random
        if not mask_phonemes:
            return self.phonemize_text(text)
        try:
            pairs = self.phonemize_words(text)
        except Exception:
            logger.debug("word-level phonemization failed; whole-string fallback")
            return self.phonemize_text(text)
        prob = 1.0 if mask_phonemes is True else float(mask_phonemes)
        out_words = []
        for word, phon in pairs:
            if rng.random() < prob:
                out_words.append(word)
            elif phon is not None:
                out_words.append(phon)
        return " ".join(out_words)

"""Word-level alignment between a text and its converted (phonemized) form.

The port's copy of ``isp_tts_tpu/data/text/word_level.py`` (the port
imports nothing of the JAX package), the same code line for line: the
sweep / backtracking group search that partitions an utterance and its
whole-string conversion into the smallest aligned groups, so that each
text group converts to its conv group in the context of the whole
utterance. Phoneme masking swaps a group's phonemes for its graphemes.
"""

from __future__ import annotations

from typing import Callable, Sequence


class WordAlignmentError(ValueError):
    """The group search could not produce a consistent partition."""


def _word_count(s: str) -> int:
    return s.count(" ") + 1 if s else 0


def _context_schedule(n_done_groups: int, words_left: int,
                      max_context: int, max_group: int):
    """Yield (context_groups, group_words) probe sizes, cheapest first.

    Grows the candidate group one word at a time while ramping the amount of
    left context at half that rate, bounded by what exists.
    """
    max_context = min(max_context, n_done_groups)
    max_group = min(max_group, words_left)
    step = 0
    while True:
        step += 1
        group = min(step, max_group)
        context = min(step // 2, max_context)
        yield context, group
        if group == max_group and context == max_context:
            return


def _probe(frontier: Sequence[tuple[int, int]], text_words: list[str],
           conv_words: list[str], conv_fn: Callable[[str], str],
           eq_fn: Callable[[str, str], bool],
           max_context: int = 4, max_group: int = 8):
    """Find the next aligned group after ``frontier[-1]``.

    Returns (n_text_words, n_conv_words) of the new group, or None when no
    probe within the search bounds validates.
    """
    t_cur, c_cur = frontier[-1]
    for n_ctx, n_words in _context_schedule(
            len(frontier) - 1, len(text_words) - t_cur, max_context, max_group):
        t_start, c_start = frontier[-1 - n_ctx]
        guess = conv_fn(" ".join(text_words[t_start:t_cur + n_words]))
        n_conv = min(_word_count(guess), len(conv_words) - c_start)
        actual = " ".join(conv_words[c_start:c_start + n_conv])
        if eq_fn(actual, guess):
            return n_words, n_conv - (c_cur - c_start)
    return None


def _refine(frontier: list[tuple[int, int]], text_words: list[str],
            conv_words: list[str], n_text: int, n_conv: int,
            conv_fn, eq_fn):
    """Split an ambiguous x-y group (x, y >= 2) at a validated boundary.

    Tries interior split points smallest-first; a split is accepted when a
    context-free probe from the split point finds a group — that can only
    happen when the guessed first half is itself a correct group. Returns
    (first_group, second_group) or None when the coarse group stands.
    """
    t_cur, c_cur = frontier[-1]
    for total in range(2, n_text + n_conv):
        for t_first in range(1, total):
            c_first = total - t_first
            if t_first >= n_text or c_first >= n_conv:
                continue
            trial = frontier + [(t_cur + t_first, c_cur + c_first)]
            rest = _probe(trial, text_words, conv_words, conv_fn, eq_fn,
                          max_context=0)
            if rest is not None:
                return (t_first, c_first), rest
    return None


def align_word_groups(text: str, conv_fn: Callable[[str], str],
                      eq_fn: Callable[[str, str], bool] | None = None):
    """Partition ``text`` and ``conv_fn(text)`` into aligned word groups.

    Returns (text_groups, conv, conv_groups) with
    ``" ".join(text_groups) == text``,
    ``" ".join(g for g in conv_groups if g is not None) == conv``, and
    ``conv_groups[i]`` the conversion of ``text_groups[i]`` in context
    (None when the group converts to nothing).
    """
    eq_fn = eq_fn or (lambda a, b: a == b)
    conv = conv_fn(text)
    text_words, conv_words = text.split(" "), conv.split(" ")
    end = (len(text_words), len(conv_words))

    frontier: list[tuple[int, int]] = [(0, 0)]
    while frontier[-1] != end:
        found = _probe(frontier, text_words, conv_words, conv_fn, eq_fn)
        if found is None:
            raise WordAlignmentError(f"no consistent group at {frontier[-1]}"
                                     f" in {text!r}")
        n_text, n_conv = found
        while n_text >= 2 and n_conv >= 2:
            t_cur, c_cur = frontier[-1]
            if n_text == 2 and n_conv == 2:
                # a 2-2 group always separates into two 1-1 groups
                frontier.append((t_cur + 1, c_cur + 1))
                n_text = n_conv = 1
                break
            split = _refine(frontier, text_words, conv_words,
                            n_text, n_conv, conv_fn, eq_fn)
            if split is None:
                break  # keep the coarse group
            (t_first, c_first), (n_text, n_conv) = split
            frontier.append((t_cur + t_first, c_cur + c_first))
        t_cur, c_cur = frontier[-1]
        frontier.append((t_cur + n_text, c_cur + n_conv))

    text_groups, conv_groups = [], []
    for (t0, c0), (t1, c1) in zip(frontier, frontier[1:]):
        text_groups.append(" ".join(text_words[t0:t1]))
        conv_groups.append(" ".join(conv_words[c0:c1]) if c1 > c0 else None)
    if " ".join(text_groups) != text or \
            " ".join(g for g in conv_groups if g is not None) != conv:
        raise WordAlignmentError(f"inconsistent partition for {text!r}")
    return text_groups, conv, conv_groups

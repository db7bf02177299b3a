"""CLIP byte-pair-encoding tokenizer.

Port of eventclip_tpu/models/clip/tokenizer.py (the tokenizer contract the
reference uses through `clip.tokenize`, models/clip_cls.py:81-83):
lowercased, whitespace-collapsed text is split by the CLIP lexer, each
piece is byte-level BPE-encoded with `</w>` word-end markers, and sequences
are wrapped in <|startoftext|> / <|endoftext|> and zero-padded to a fixed
context length.

The JAX package's lexer is a pattern of the third-party `regex` package;
this one is a hand-written scanner with the same alternation order (the
two special tokens, the seven contractions, letter runs, one number
character, runs of neither space nor letter nor number) over the code-point
tables of unicode_classes.py, which equal that pattern's classes.

The merge table is the standard `bpe_simple_vocab_16e6.txt.gz` asset from
the CLIP release. Pass its path, set EVENTCLIP_BPE_PATH, or drop it at
eventclip_tpu_torch/assets/bpe_simple_vocab_16e6.txt.gz.

`_clean` reproduces the effects of the reference's ftfy.fix_text that can
matter for user-supplied names: HTML-entity unescaping, mojibake repair
(UTF-8 text mis-decoded as cp1252/latin-1, only when the whole string
round-trips as valid UTF-8) and NFC normalization.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from bisect import bisect_right
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from .unicode_classes import (LETTER, LITERAL_MATCHES, NO_CLASS, NUMBER,
                              WHITESPACE)

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"

# the lexer's literal alternatives, in its order
_LITERALS = (SOT, EOT, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# regex's `\s+` (stdlib `\s` also takes U+001C-U+001F)
_SPACES = re.compile("[" + "".join(
    re.escape(chr(c)) for c in sorted(WHITESPACE)) + "]+")

# static candidates: the package asset directory and, as a fallback, a
# repo-root assets/ directory
DEFAULT_BPE_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "assets",
                 "bpe_simple_vocab_16e6.txt.gz"),
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "assets",
                 "bpe_simple_vocab_16e6.txt.gz"),
)


def bpe_asset_paths() -> Tuple[str, ...]:
    """Candidate vocab locations, EVENTCLIP_BPE_PATH override first (read
    at call time, so a vocab can be pointed at after import)."""
    return (os.environ.get("EVENTCLIP_BPE_PATH", ""),) + DEFAULT_BPE_PATHS


def _is_letter(c: int) -> bool:
    return bisect_right(LETTER, c) & 1 == 1


def _is_number(c: int) -> bool:
    return bisect_right(NUMBER, c) & 1 == 1


def _is_other(c: int) -> bool:
    """`[^\\s\\p{L}\\p{N}]` under IGNORECASE."""
    return not (c in WHITESPACE or c in NO_CLASS or _is_letter(c)
                or _is_number(c))


def _literal_at(text: str, i: int, literal: str) -> bool:
    if i + len(literal) > len(text):
        return False
    return all(text[i + j] in LITERAL_MATCHES[ch]
               for j, ch in enumerate(literal))


def _run_end(text: str, i: int, pred) -> int:
    while i < len(text) and pred(ord(text[i])):
        i += 1
    return i


def lex(text: str) -> List[str]:
    """The CLIP lexer's pieces of `text` (the JAX package's
    `regex.findall(_LEXER, text)`): at each position the first alternative
    that matches wins; a character no alternative matches is skipped."""
    pieces: List[str] = []
    i = 0
    while i < len(text):
        literal = next((lit for lit in _LITERALS
                        if _literal_at(text, i, lit)), None)
        c = ord(text[i])
        if literal is not None:
            end = i + len(literal)
        elif _is_letter(c):
            end = _run_end(text, i + 1, _is_letter)
        elif _is_number(c):
            end = i + 1
        elif _is_other(c):
            end = _run_end(text, i + 1, _is_other)
        else:
            i += 1
            continue
        pieces.append(text[i:end])
        i = end
    return pieces


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte <-> printable unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# a UTF-8 multibyte sequence seen through a single-byte decode: a lead byte
# 0xC2-0xF4 followed by a continuation byte 0x80-0xBF
_UTF8_SEQ = re.compile(rb"[\xc2-\xf4][\x80-\xbf]")


def _encode_sloppy_cp1252(text: str):
    """The bytes `text` came from if it was a cp1252/latin-1 mis-decode
    (cp1252 where defined, latin-1 ordinals in cp1252's holes), or None
    when some character cannot have come from a single byte."""
    out = bytearray()
    for ch in text:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            if ord(ch) < 0x100:
                out.append(ord(ch))
            else:
                return None
    return bytes(out)


def _fix_mojibake(text: str) -> str:
    """Repair UTF-8 text that was mis-decoded as cp1252/latin-1 ("cafÃ©" ->
    "café"), only when the whole string re-encodes as sloppy cp1252, holds
    a UTF-8 multibyte signature and strictly decodes as UTF-8; up to three
    passes undo double encoding."""
    for _ in range(3):
        data = _encode_sloppy_cp1252(text)
        if data is None or not _UTF8_SEQ.search(data):
            return text
        try:
            fixed = data.decode("utf-8")
        except UnicodeDecodeError:
            return text
        if fixed == text:
            return text
        text = fixed
    return text


def _clean(text: str) -> str:
    # ftfy.fix_text's order: unescape, then mojibake repair, then NFC
    text = html.unescape(html.unescape(text))
    text = _fix_mojibake(text)
    text = unicodedata.normalize("NFC", text)
    text = _SPACES.sub(" ", text)
    return text.strip()


def parse_merges(text: str) -> List[Tuple[str, str]]:
    """Decoded BPE vocab file contents -> the merge list (a version header
    line, then at most 48894 usable merges)."""
    lines = text.split("\n")
    return [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]


class SimpleTokenizer:
    def __init__(self, bpe_path: str = None,
                 merges: Sequence[Tuple[str, str]] = None):
        if merges is None:
            merges = self._load_merges(bpe_path)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab = vocab + ["".join(m) for m in merges]
        vocab = vocab + [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}

    @staticmethod
    def _load_merges(bpe_path):
        if bpe_path is None:
            for cand in bpe_asset_paths():
                if cand and os.path.exists(cand):
                    bpe_path = cand
                    break
        if bpe_path is None or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merge table not found; place "
                "bpe_simple_vocab_16e6.txt.gz under assets/ or set "
                "EVENTCLIP_BPE_PATH"
            )
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            return parse_merges(f.read())

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in lex(_clean(text).lower()):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(
    texts: Union[str, Sequence[str]],
    tokenizer: SimpleTokenizer,
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """Texts -> [B, context_length] int32 (SOT ... EOT, zero padded)."""
    if isinstance(texts, str):
        texts = [texts]
    sot, eot = tokenizer.encoder[SOT], tokenizer.encoder[EOT]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + tokenizer.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out

"""The port's BPE tokenizer equals the JAX package's: the same ids for the
same text under the same merge table, the lexer's pieces equal to the
`regex` pattern's, and the committed code-point tables equal to `regex`'s
classes on every code point. Only this test imports `regex`; the port
never does."""

import gzip
import os

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from eventclip_tpu.data.datasets import (CALTECH_NEW_CNAMES,
                                         load_split_asset)
from eventclip_tpu.models import classifier as ref_classifier
from eventclip_tpu.models.clip import tokenizer as ref_tok
from eventclip_tpu_torch.models import classifier
from eventclip_tpu_torch.models.clip import tokenizer as tok
from eventclip_tpu_torch.models.clip import unicode_classes as uc
from eventclip_tpu_torch.utils.config import load_params

from .test_tokenizer import MERGES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every code point but the surrogates
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
IGNORECASE_CLASSES = {
    "letter": (r"[\p{L}]", tok._is_letter),
    "number": (r"[\p{N}]", tok._is_number),
    "other": (r"[^\s\p{L}\p{N}]", tok._is_other),
}

TEXTS = [
    "a point cloud image of a cat",
    "A   POINT\tcloud\nimage",
    "<|startoftext|>a cat<|endoftext|>",
    "<|STARTOFTEXT|> <|\u017ftartoftext|> !<|endoftext|>",
    "it's we're they've I'm we'll he'd don't IT'S it'\u017f",
    "x'sy 'll'd ''s",
    "abc123def 4\u0663\uff15 \u2160\u2161 \u00bd",
    "caf\u00e9 cafe\u0301 cafe&#769; caf&#195;&#169; caf\u00c3\u00a9",
    "\u00e2\u20ac\u0153ok\u00e2\u20ac\u009d &amp;lt; &lt;b&gt;",
    "Gr\u00f6\u00dfe \u03bd\u03b1\u03cc\u03c2 \u0416\u0443\u043a",
    "\u4e2d\u6587 \u65e5\u672c\u8a9e \ud55c\uad6d\uc5b4",
    "emoji \U0001f600\U0001f431\u200d\U0001f464 \u2764\ufe0f!!",
    "u+1c\x1cu+1d\x1du+1e\x1eu+1f\x1f end",
    "\u0345 a\u0345b \u0345\u0345 ypogegrammeni",
    "new letters \u088f\u0c5c\u1c89\ua7cb and \u00a0nbsp\u3000ideo",
    "under_score hy-phen dot.ted (paren) [bracket] {brace}",
    "   leading and trailing   ",
    "",
]


@pytest.fixture(scope="module")
def toks():
    return tok.SimpleTokenizer(merges=MERGES), ref_tok.SimpleTokenizer(
        merges=MERGES)


@pytest.mark.parametrize("name", sorted(IGNORECASE_CLASSES))
def test_class_table_equals_regex_on_every_code_point(name):
    """Each lexer class, as compiled in the lexer (IGNORECASE), against the
    port's table lookup: regex 2026.7.19 is the reference, not unicodedata."""
    pattern, pred = IGNORECASE_CLASSES[name]
    match = regex.compile(pattern, regex.IGNORECASE).match
    bad = [hex(c) for c in CODE_POINTS
           if bool(match(chr(c))) != pred(c)]
    assert not bad, bad[:20]


def test_whitespace_table_equals_regex_on_every_code_point():
    match = regex.compile(r"\s").match
    want = {c for c in CODE_POINTS if match(chr(c))}
    assert set(uc.WHITESPACE) == want
    # str.isspace() is not the lexer's \s
    assert {c for c in range(0x1C, 0x20) if chr(c).isspace()} - want


def test_literal_matches_equal_regex():
    for ch, matches in uc.LITERAL_MATCHES.items():
        match = regex.compile(regex.escape(ch), regex.IGNORECASE).match
        assert set(matches) == {chr(c) for c in CODE_POINTS
                                if match(chr(c))}, ch


@pytest.mark.parametrize("text", TEXTS)
def test_lexer_equals_regex(text):
    for s in (text, text.lower()):
        assert tok.lex(s) == regex.findall(ref_tok._LEXER, s), s


@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_tokenize_equal_jax(toks, text):
    port, ref = toks
    assert port.encode(text) == ref.encode(text)
    assert tok._clean(text) == ref_tok._clean(text)
    assert tok._fix_mojibake(text) == ref_tok._fix_mojibake(text)
    got = tok.tokenize([text, "of " + text], port, context_length=77,
                       truncate=True)
    want = ref_tok.tokenize([text, "of " + text], ref, context_length=77,
                            truncate=True)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))


@settings(max_examples=300, deadline=None, database=None)
@given(st.text(max_size=40))
def test_hypothesis_corpus_equals_jax(text):
    port = tok.SimpleTokenizer(merges=MERGES)
    ref = ref_tok.SimpleTokenizer(merges=MERGES)
    assert tok.lex(text.lower()) == regex.findall(ref_tok._LEXER,
                                                  text.lower())
    assert port.encode(text) == ref.encode(text)


def test_vocab_and_merges_equal_jax(toks, tmp_path, monkeypatch):
    port, ref = toks
    assert tok.bytes_to_unicode() == ref_tok.bytes_to_unicode()
    assert port.encoder == ref.encoder and port.bpe_ranks == ref.bpe_ranks
    for word in ("point", "of", "image", "cat", "a", "mage"):
        assert port.bpe(word) == ref.bpe(word)
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "\n".join(" ".join(m) for m in MERGES) + "\n")
    text = path.read_bytes()
    assert tok.parse_merges(gzip.decompress(text).decode()) == \
        ref_tok.parse_merges(gzip.decompress(text).decode())
    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(path))
    assert tok.bpe_asset_paths()[0] == str(path)
    assert tok.SimpleTokenizer().encoder == ref_tok.SimpleTokenizer().encoder


def test_missing_vocab_raises_like_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("EVENTCLIP_BPE_PATH", str(tmp_path / "none.txt.gz"))
    monkeypatch.setattr(tok, "DEFAULT_BPE_PATHS", ())
    monkeypatch.setattr(ref_tok, "DEFAULT_BPE_PATHS", ())
    for module in (tok, ref_tok):
        with pytest.raises(FileNotFoundError, match="EVENTCLIP_BPE_PATH"):
            module.SimpleTokenizer()


def test_too_long_raises_like_jax(toks):
    long = "a point " * 50
    for module, t in zip((tok, ref_tok), toks):
        with pytest.raises(RuntimeError, match="too long"):
            module.tokenize([long], t, context_length=77)


def test_tokenize_prompts_equal_on_ncaltech_names(toks):
    """All 101 N-Caltech class names (the shipped split's folders, CoOp
    renames applied) through the config's prompt."""
    folders = sorted({p.split("/")[-2] for p in
                      load_split_asset("NCaltech101", 2, True)})
    names = [CALTECH_NEW_CNAMES.get(c, c) for c in folders]
    assert len(folders) == 101
    prompt = load_params(os.path.join(
        ROOT, "configs/zsclip/zsclip_ncaltech_params.py")).clip_dict["prompt"]
    assert prompt == classifier.DEFAULT_PROMPT == ref_classifier.DEFAULT_PROMPT
    port, ref = toks
    got = classifier.tokenize_prompts(names, prompt, port, 77)
    want = ref_classifier.tokenize_prompts(names, prompt, ref, 77)
    assert got.shape == (101, 77)
    np.testing.assert_array_equal(got, want)

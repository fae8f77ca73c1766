"""Port parity of the hash tokenizer: ``repro_torch.data.tokenizer``
(``PAD_ID``, ``tokenize``, ``tokenize_batch``) against the JAX
package's ``repro.data.tokenizer`` on the CPU.  The ids must be equal,
dtype and shape included, for every kind of text a batch may hold."""
import numpy as np
import pytest

from repro.data import tokenizer as jtok
from repro_torch.data import tokenizer

TEXTS = {
    "empty": ["", "   ", "!?"],
    "over_long": [" ".join(f"w{i}" for i in range(40)),
                  "the quick brown fox " * 12],
    "mixed_case": ["Hello WORLD hello world", "MiXeD CaSe 42 Words"],
    "punctuated": ["a,b;c.d!e?f", "hi-there: (it's) [ok] {yes} 3.14/2"],
    "non_ascii": ["café naïve façade", "東京 タワー 2024", "Ωmega — ünïcode é"],
}


@pytest.mark.parametrize("kind", sorted(TEXTS))
@pytest.mark.parametrize("vocab,max_len", [(30_522, 8), (97, 32)])
def test_tokenize_batch_equals_the_reference(kind, vocab, max_len):
    texts = TEXTS[kind]
    got = tokenizer.tokenize_batch(texts, vocab, max_len)
    want = jtok.tokenize_batch(texts, vocab, max_len)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (len(texts), max_len)
    np.testing.assert_array_equal(got, want)


def test_tokenize_pads_and_truncates():
    assert tokenizer.PAD_ID == jtok.PAD_ID == -1
    ids = tokenizer.tokenize("one two three", 50, 5)
    assert (ids[3:] == tokenizer.PAD_ID).all() and (ids[:3] >= 0).all()
    assert (tokenizer.tokenize("a " * 9, 50, 4) != tokenizer.PAD_ID).all()
    np.testing.assert_array_equal(tokenizer.tokenize("Ab AB ab", 1000, 3),
                                  jtok.tokenize("Ab AB ab", 1000, 3))

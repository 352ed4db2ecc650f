"""The port's content-addressed chunk store (``content/chunks.py``)
against the JAX package's on seeded content, a ragged last chunk
included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.content import chunks as rc  # noqa: E402
from repro.core.protocol import ArtifactStore as RStore  # noqa: E402
from repro_torch.content import chunks as tc  # noqa: E402
from repro_torch.core.protocol import ArtifactStore as TStore  # noqa: E402

pytestmark = pytest.mark.torch

#: (artifact tokens, chunk tokens): even, ragged, one chunk, one token
GEOMETRIES = [(64, 16), (70, 16), (16, 64), (5, 1)]


def _content(rng, tokens):
    return [int(t) for t in rng.integers(0, 50_000, tokens)]


@pytest.mark.parametrize("tokens,chunk", GEOMETRIES)
def test_split_reassemble_digest_diff_apply(tokens, chunk):
    rng = np.random.default_rng(tokens * 100 + chunk)
    cur = _content(rng, tokens)
    new = list(cur)
    for i in rng.choice(tokens, size=max(1, tokens // 7), replace=False):
        new[i] += 1
    assert tc.split_chunks(cur, chunk) == rc.split_chunks(cur, chunk)
    assert tc.reassemble(tc.split_chunks(cur, chunk)) == tuple(cur)
    assert tc.n_chunks(tokens, chunk) == rc.n_chunks(tokens, chunk)
    np.testing.assert_array_equal(tc.chunk_sizes(tokens, chunk),
                                  rc.chunk_sizes(tokens, chunk))
    for c in tc.split_chunks(cur, chunk):
        assert tc.chunk_digest(c) == rc.chunk_digest(c)
    mask = tc.diff_chunks(cur, new, chunk)
    np.testing.assert_array_equal(mask, rc.diff_chunks(cur, new, chunk))
    delta = [(int(i), tc.split_chunks(new, chunk)[i])
             for i in np.flatnonzero(mask)]
    assert tc.apply_delta(cur, delta, chunk) == tuple(new)
    assert tc.apply_delta(cur, delta, chunk) == rc.apply_delta(cur, delta,
                                                               chunk)
    with pytest.raises(ValueError):
        tc.diff_chunks(cur, cur + [1] * chunk, chunk)


@pytest.mark.parametrize("tokens,chunk", GEOMETRIES)
def test_chunk_store_register_write_fetch(tokens, chunk):
    rng = np.random.default_rng(7 + tokens)
    stores = []
    for Store, mod in ((TStore, tc), (RStore, rc)):
        store = Store()
        chunks = mod.ChunkStore(store, chunk)
        for d in range(3):
            store.put(f"a{d}", _content(np.random.default_rng(d), tokens))
            chunks.register(f"a{d}")
        stores.append((store, chunks))
    (ts, tcs), (rs, rcs) = stores
    for step in range(6):
        name = f"a{step % 3}"
        new = list(ts.get(name))
        for i in rng.choice(tokens, size=max(1, tokens // 5), replace=False):
            new[i] = step * 1000 + int(i)
        np.testing.assert_array_equal(tcs.diff_mask(name, new),
                                      rcs.diff_mask(name, new))
        np.testing.assert_array_equal(tcs.put(name, new), rcs.put(name, new))
        idx = rng.choice(tcs.n_chunks_of(name),
                         size=1 + step % tcs.n_chunks_of(name),
                         replace=False)
        assert tcs.delta(name, idx) == rcs.delta(name, idx)
        assert tcs.reassembled(name) == tuple(ts.get(name)) == \
            rcs.reassembled(name)
        assert tcs.n_unique_chunks == rcs.n_unique_chunks
    last = tcs.chunk("a0", tcs.n_chunks_of("a0") - 1)
    assert len(last) == tokens - (tcs.n_chunks_of("a0") - 1) * chunk

"""The port's token pipeline (``repro_torch.data``) against the reference's:
batches bit-identical for every ``(seed, step, shard)``, on the synthetic
Markov stream and on an ``np.memmap`` store, with the reference's own
determinism, sharding, Markov-structure and straggler checks."""

import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro_torch.data import DataConfig, TokenPipeline


def _pair(**kw):
    return TokenPipeline(DataConfig(**kw)), JaxTokenPipeline(JaxDataConfig(**kw))


def _same(a, b):
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed,branching", [(0, 4), (42, 3), (7, 8)])
def test_markov_batches_bit_identical(seed, branching):
    port, ref = _pair(vocab=128, seq_len=32, global_batch=8, num_shards=4, seed=seed,
                      branching=branching)
    np.testing.assert_array_equal(port.successors, ref.successors)
    np.testing.assert_array_equal(port.trans_p, ref.trans_p)
    for step in (0, 1, 5, 1000):
        for shard in range(4):
            _same(port.batch_at(step, shard), ref.batch_at(step, shard))
        _same(port.global_batch_at(step), ref.global_batch_at(step))


def test_memmap_batches_bit_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 500, size=10_000).astype(np.int32).tofile(path)
    port, ref = _pair(vocab=500, seq_len=63, global_batch=6, num_shards=2, seed=11,
                      token_file=str(path))
    for step in (0, 2, 77):
        for shard in range(2):
            got = port.batch_at(step, shard)
            _same(got, ref.batch_at(step, shard))
            np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
        _same(port.global_batch_at(step), ref.global_batch_at(step))


def test_entropy_floor_reassign_and_global_batch():
    port, ref = _pair(vocab=128, seq_len=32, global_batch=8, num_shards=4, seed=42)
    assert port.entropy_floor == ref.entropy_floor
    assert 0 < port.entropy_floor < np.log(128)
    assert port.global_batch_at(0)["tokens"].shape == (8, 32)
    before = port.batch_at(7, shard=3)
    port.reassign(3, 1)
    ref.reassign(3, 1)
    assert port.effective_shard(3) == ref.effective_shard(3) == 1
    _same(port.batch_at(7, 3), port.batch_at(7, 1))
    _same(port.batch_at(7, 3), ref.batch_at(7, 3))
    assert not np.array_equal(before["tokens"], port.batch_at(7, 3)["tokens"])
    _same(port.global_batch_at(4), ref.global_batch_at(4))


def test_deterministic_distinct_and_markov():
    pipe = TokenPipeline(DataConfig(vocab=128, seq_len=32, global_batch=8, num_shards=4,
                                    seed=42))
    _same(pipe.batch_at(5, 2), pipe.batch_at(5, 2))
    assert not np.array_equal(pipe.batch_at(5, 0)["tokens"], pipe.batch_at(5, 1)["tokens"])
    assert not np.array_equal(pipe.batch_at(5, 0)["tokens"], pipe.batch_at(6, 0)["tokens"])
    b = pipe.batch_at(3, 1)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert np.isin(b["labels"][:, 0], pipe.successors[b["tokens"][:, 0]]).all()


def test_shards_must_divide_the_batch():
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab=16, seq_len=4, global_batch=6, num_shards=4))

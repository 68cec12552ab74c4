"""The port's token pipeline against the JAX package's, batch for batch.

``repro_torch.data.TokenPipeline`` must give the same int32 ``tokens``
and ``targets`` as ``repro.data.TokenPipeline`` for the same
``DataConfig``, bit for bit (the same numpy generator drawn in the same
order: the Zipf CDF, the EOS-delimited documents), over several seeds,
batch sizes, sequence lengths and vocabularies, for several batches in a
row, and the same document-length samples after them.
"""
import dataclasses

import numpy as np
import pytest

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro_torch.data import DataConfig, TokenPipeline


@pytest.mark.parametrize("seed,batch,seq,vocab", [
    (0, 8, 256, 128256),
    (1, 2, 16, 128),
    (7, 3, 65, 50280),
    (123, 1, 1, 512),
    (5, 4, 600, 1000),        # sequences longer than the mean document
])
def test_batches_equal_the_jax_pipeline_bit_for_bit(seed, batch, seq, vocab):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    port, ref = TokenPipeline(DataConfig(**kw)), JaxTokenPipeline(
        JaxDataConfig(**kw))
    for want, got in zip([ref.next_batch() for _ in range(3)], iter(port)):
        assert set(got) == set(want) == {"tokens", "targets"}
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == (batch, seq)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["targets"][:, :-1])
    np.testing.assert_array_equal(port.output_length_samples(50),
                                  ref.output_length_samples(50))


def test_config_fields_and_defaults_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(DataConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JaxDataConfig)])


def test_tokens_skip_pad_and_mark_documents_with_eos():
    cfg = DataConfig(vocab_size=64, seq_len=2000, batch_size=2, seed=3,
                     doc_len_mean=20.0)
    toks = TokenPipeline(cfg).next_batch()["tokens"]
    assert toks.min() >= cfg.eos_id and toks.max() < cfg.vocab_size
    assert not (toks == cfg.pad_id).any()
    assert (toks == cfg.eos_id).sum() > 2 * 2000 / 25   # about one per doc

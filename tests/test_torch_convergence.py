"""Held-out convergence of the port on learnable synthetic data: the CPU
mirror of ``tests/test_convergence.py`` at its sizes and thresholds.

``CorrelatedSyntheticDataset`` ties the two modalities through shared
latent topics, so retrieval on a held-out split (other videos, the same
topics) above chance shows that the port's objective and optimizer learn a
cross-modal embedding that generalizes, not a memorized gallery. The run
is seeded (the port's own weights from its generator), and the thresholds
are the JAX test's, far above chance (R@1 chance on the 64-video split is
1.6%, rsum ~50)."""

import numpy as np

import torch

from cmhse_tpu_torch.config import (DataConfig, ExperimentConfig, LossConfig,
                                    ModelConfig, TrainConfig)
from cmhse_tpu_torch.data import (CorrelatedSyntheticDataset,
                                  batches_from_dataset)
from cmhse_tpu_torch.eval import validate_metrics
from cmhse_tpu_torch.models import CMHSE
from cmhse_tpu_torch.train import (create_train_state, set_learning_rate,
                                   train_step)

torch.set_num_threads(2)
_DS_KW = dict(feat_dim=32, vocab_size=200, max_clips=4, max_frames=10,
              max_words=8, num_topics=10)


def _cfg(epochs):
    return ExperimentConfig(
        name="convergence",
        data=DataConfig(batch_size=16, feat_dim=32, vocab_size=200,
                        max_clips=4, max_frames=10, max_sentences=4,
                        max_words=8),
        model=ModelConfig(embed_size=48, word_dim=24, feat_dim=32,
                          rnn_hidden=48, hierarchical=True),
        loss=LossConfig(),
        train=TrainConfig(num_epochs=epochs, lr=2e-3),
    )


def test_heldout_retrieval_beats_chance():
    cfg = _cfg(epochs=3)
    train_ds = CorrelatedSyntheticDataset(num_videos=320, seed=0, **_DS_KW)
    val_ds = CorrelatedSyntheticDataset(num_videos=64, seed=99, **_DS_KW)
    model = CMHSE(cfg.model, cfg.data.vocab_size, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)

    first_loss = None
    for epoch in range(cfg.train.num_epochs):
        state = set_learning_rate(state, cfg.train.lr)
        for batch in batches_from_dataset(train_ds, cfg.data, shuffle=True,
                                          seed=epoch):
            state, metrics = train_step(state, batch, cfg.loss)
            if first_loss is None:
                first_loss = float(metrics["loss"])
    final_loss = float(metrics["loss"])

    mets = validate_metrics(
        model, batches_from_dataset(val_ds, cfg.data, shuffle=False),
        ks=(1, 5, 10))
    v2p_r1 = float(mets["v2p_r@1"])
    rsum = float(mets["rsum"])

    assert final_loss < first_loss, (first_loss, final_loss)
    # the JAX test's thresholds (its observed v2p R@1 ~27%, rsum ~240)
    assert v2p_r1 >= 10.0, f"held-out v2p R@1 {v2p_r1} barely above chance"
    assert rsum >= 120.0, f"held-out rsum {rsum} barely above chance"


def test_correlated_dataset_is_deterministic_and_split_consistent():
    a = CorrelatedSyntheticDataset(num_videos=8, seed=0, **_DS_KW)
    b = CorrelatedSyntheticDataset(num_videos=8, seed=0, **_DS_KW)
    ea, eb = a[3], b[3]
    assert all(np.array_equal(x, y) for x, y in zip(ea.clips, eb.clips))
    assert all(np.array_equal(x, y) for x, y in zip(ea.sentences,
                                                    eb.sentences))
    # another split seed: other videos, the same topic prototypes
    c = CorrelatedSyntheticDataset(num_videos=8, seed=1, **_DS_KW)
    assert not np.array_equal(a[3].clips[0], c[3].clips[0])
    np.testing.assert_array_equal(a.prototypes, c.prototypes)
    # the length probe agrees with the realized example
    for i in range(8):
        assert a.max_frame_len(i) == max(cl.shape[0] for cl in a[i].clips)

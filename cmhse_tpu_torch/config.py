"""Frozen dataclass configuration, the port's own copy of
``cmhse_tpu/config.py`` (the port imports nothing of the JAX package).

Field names, defaults, ``to_json``/``from_json`` and ``PRESETS`` are kept
identical so that a ``config.json`` written by either package loads in the
other (pinned by tests/test_torch_config.py). Some fields only steer the JAX
package (``pallas_gru``, ``use_pallas``, ``mesh_*``, ``steps_per_dispatch``);
the port reads them back and writes them out unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    """Data contract for bucketed, masked, fixed-shape batches.

    Array-of-structs spec (SURVEY.md section 7 step 1):
      frames     [B, Cmax, Fmax, feat_dim]      video clip frame features
                 (``feature_dtype``: f32 default, bf16 opt-in)
      frame_len  i32[B, Cmax]                   valid frames per clip
      clip_len   i32[B]                         valid clips per video
      words      i32[B, Smax, Wmax]             caption token ids
      word_len   i32[B, Smax]                   valid words per sentence
      sent_len   i32[B]                         valid sentences per paragraph
    """

    dataset: str = "anet_precomp"  # mirrors reference --data_name
    data_path: str = "data/"
    feat_dim: int = 500  # C3D-PCA feature size (ActivityNet challenge release)
    vocab_size: int = 10000
    batch_size: int = 64
    # Static padded shape caps (one bucket = one compiled program).
    max_clips: int = 8  # Cmax
    max_frames: int = 64  # Fmax (frames per clip)
    max_sentences: int = 8  # Smax
    max_words: int = 32  # Wmax
    # Length-bucketing edges, ascending; each (frames, words) pair is one
    # bucket; bounds XLA recompiles (SURVEY.md "hard parts" item 3).
    frame_buckets: tuple[int, ...] = (16, 32, 64)
    word_buckets: tuple[int, ...] = (8, 16, 32)
    # fixed_shape=True: every batch uses the maximal caps — ONE compiled
    # program per epoch. False: per-batch bucket edges from the batch's
    # longest member — fewer padding FLOPs, up to
    # len(frame_buckets) x len(word_buckets) compiles.
    fixed_shape: bool = True
    # batch together examples of similar frame length so short batches land
    # in small buckets (epoch-level equivalent of the reference's
    # sort-by-length collate; batch ORDER stays shuffled)
    group_by_length: bool = False
    shuffle_seed: int = 0
    # Pretrained word2vec vectors applied to the embedding table after init
    # (reference [B:7]: word2vec-initialized text encoder). Empty = random.
    word2vec_path: str = ""
    # dtype of the frames arrays the loader emits ("float32" | "bfloat16").
    # bf16 halves feature DMA and the device-side convert ahead of the first
    # GEMM; numerically identical for bf16-compute models (which cast their
    # inputs immediately). Keep float32 for f32/parity runs.
    feature_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    """Encoder stack (SURVEY.md C4-C6, C8; reference ``model.py``)."""

    embed_size: int = 1024  # joint embedding dim (reference --embed_size)
    word_dim: int = 300  # word embedding dim (word2vec-initialized)
    feat_dim: int = 500
    rnn_hidden: int = 1024
    hierarchical: bool = True  # False => flat VSE-style model (config 1)
    attention_pool: bool = False  # config 3: attention pooling over states
    reconstruction: bool = False  # config 3: layer-wise reconstruction (C8)
    bidirectional: bool = False
    readout: str = "last"  # "last" | "mean" (low-level GRU readout)
    dtype: str = "float32"  # compute dtype for activations
    param_dtype: str = "float32"
    pallas_gru: bool = False  # fused Pallas GRU kernels (forward time loop +
    # BPTT custom VJP) — valid for training AND encode; off by default
    # because interpret mode is slower than the scan off-TPU. Encode paths
    # and the train CLI auto-enable it on real TPU.

    def __post_init__(self):
        if self.reconstruction and not self.hierarchical:
            # the layer-wise term reconstructs LOW-level sequences from the
            # HIGH-level embedding (paper C8) — the flat model has no
            # hierarchy to reconstruct. Silently ignoring the flag trained
            # with the tau term quietly absent (review r5); fail at config
            # time instead.
            raise ValueError(
                "reconstruction=True requires hierarchical=True (the "
                "layer-wise term reconstructs low-level sequences from "
                "the high-level embedding; the flat model has neither)")


@dataclass(frozen=True)
class LossConfig:
    """Contrastive ranking loss (SURVEY.md C7; paper eq. for max-of-hinges)."""

    margin: float = 0.2
    max_violation: bool = True  # VSE++ in-batch hardest negative
    low_weight: float = 1.0  # weight on clip<->sentence level loss
    high_weight: float = 1.0  # weight on video<->paragraph level loss
    recon_weight: float = 5e-4  # tau, layer-wise reconstruction term (C8)
    use_pallas: bool = True  # fused sim+hinge kernel (max_violation only;
    # interpret-mode off-TPU, so correctness is platform-independent)


@dataclass(frozen=True)
class TrainConfig:
    """Training loop knobs (SURVEY.md C10; reference ``train.py``)."""

    num_epochs: int = 50
    lr: float = 1e-3  # Adam (reference default 2e-4..1e-3 range)
    lr_update: int = 15  # decay lr by 10x every lr_update epochs
    lr_decay: float = 0.1
    grad_clip: float = 2.0  # clip_grad_norm threshold
    val_step: int = 500  # validate every N steps
    log_step: int = 10
    seed: int = 42
    checkpoint_dir: str = "runs/checkpoint"
    resume: str = ""  # path to checkpoint to resume from
    mesh_shape: tuple[int, ...] = (-1,)  # -1 = all visible devices
    mesh_axes: tuple[str, ...] = ("data",)
    # Update steps executed per jit dispatch (lax.scan over stacked batches,
    # train/state.py::train_steps). >1 amortizes host->device dispatch
    # latency — the dominant per-step cost through a network-attached TPU
    # and a measurable one at scale on attached VMs. Requires fixed-shape
    # batches; log/val cadence rounds to dispatch boundaries.
    steps_per_dispatch: int = 1
    # Preemption-safe mid-epoch snapshots: save a resumable checkpoint every
    # N global steps (0 = off; the reference checkpoints per epoch only).
    # The snapshot records how many dispatch groups of the current epoch are
    # already consumed; resume skips exactly those groups (the per-epoch
    # shuffle is seeded, so the stream reproduces) and continues the epoch
    # instead of redoing it — TPU-pod preemption is routine in production.
    snapshot_step: int = 0


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        model_raw = dict(raw.get("model", {}))
        if (model_raw.get("reconstruction")
                and not model_raw.get("hierarchical", True)):
            # legacy config.json written before ModelConfig started
            # REJECTING reconstruction+flat: back then the flag was
            # silently ignored (the flat model has no hierarchy to
            # reconstruct), so dropping it here restores the exact trained
            # behavior instead of making the checkpoint unloadable
            print("config: legacy flat+reconstruction config.json — "
                  "reconstruction disabled (the flat model never had the "
                  "recon term)")
            model_raw["reconstruction"] = False
        return cls(
            name=raw.get("name", "default"),
            data=_make(DataConfig, raw.get("data", {})),
            model=_make(ModelConfig, model_raw),
            loss=_make(LossConfig, raw.get("loss", {})),
            train=_make(TrainConfig, raw.get("train", {})),
        )

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _make(cls: type, raw: dict) -> Any:
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for k, v in raw.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(v)
        kept[k] = v
    return cls(**kept)


def _preset_1() -> ExperimentConfig:
    """BASELINE config 1: flat GRU (VSE-style, no hierarchy), 100-video
    ActivityNet subset, batch 32, CPU-scale (BASELINE.json:7)."""
    return ExperimentConfig(
        name="flat_anet_subset",
        data=DataConfig(batch_size=32, max_clips=1, max_frames=128,
                        max_sentences=1, max_words=96,
                        frame_buckets=(128,), word_buckets=(96,)),
        model=ModelConfig(hierarchical=False),
        loss=LossConfig(low_weight=0.0, high_weight=1.0, recon_weight=0.0),
        train=TrainConfig(num_epochs=15),
    )


def _preset_2() -> ExperimentConfig:
    """BASELINE config 2: full hierarchical clip->video + sentence->paragraph
    GRU encoders, ActivityNet train/val1 (BASELINE.json:8)."""
    return ExperimentConfig(
        name="hier_anet",
        model=ModelConfig(hierarchical=True),
        loss=LossConfig(low_weight=1.0, high_weight=1.0, recon_weight=0.0),
    )


def _preset_3() -> ExperimentConfig:
    """BASELINE config 3: hierarchical + attention pooling + low/high loss
    weighting + reconstruction tau (the full CMHSE config; BASELINE.json:9)."""
    return ExperimentConfig(
        name="cmhse_full",
        model=ModelConfig(hierarchical=True, attention_pool=True,
                          reconstruction=True),
        loss=LossConfig(low_weight=1.0, high_weight=1.0, recon_weight=5e-4),
    )


def _preset_4() -> ExperimentConfig:
    """BASELINE config 4: DiDeMo — variable-length moment clips; stress test
    for the ragged bucketing/masking path (BASELINE.json:10)."""
    return ExperimentConfig(
        name="didemo",
        data=DataConfig(dataset="didemo_precomp", max_clips=6, max_frames=48,
                        max_sentences=6, max_words=32,
                        frame_buckets=(12, 24, 48), word_buckets=(8, 16, 32),
                        # DiDeMo's moment clips are highly variable-length:
                        # bucketed batches cut the padding FLOPs (B:10)
                        fixed_shape=False, group_by_length=True),
        model=ModelConfig(hierarchical=True, attention_pool=True),
        loss=LossConfig(recon_weight=0.0),  # model has no recon decoders
    )


def _preset_5() -> ExperimentConfig:
    """BASELINE config 5: large-gallery eval — 10k-video similarity matrix
    sharded across a v5e-8 mesh with on-device R@k / median-rank reduction
    (BASELINE.json:11). Its ``mesh_shape=(8,)`` asks for 8 ranks:
    ``parallel.make_mesh`` raises in a run of fewer, as the JAX package's
    does with fewer devices; a smaller run passes ``mesh_shape=(-1,)``."""
    return ExperimentConfig(
        name="large_gallery_eval",
        data=DataConfig(batch_size=512),
        model=ModelConfig(hierarchical=True),
        loss=LossConfig(recon_weight=0.0),  # model has no recon decoders
        train=TrainConfig(mesh_shape=(8,), mesh_axes=("data",)),
    )


PRESETS = {
    "flat_anet_subset": _preset_1,
    "hier_anet": _preset_2,
    "cmhse_full": _preset_3,
    "didemo": _preset_4,
    "large_gallery_eval": _preset_5,
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()

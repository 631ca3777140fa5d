"""Typed configuration dataclasses and the experiment registry of the port.

A plain copy of `rails_tpu/core/config.py` (which imports only the standard
library), so that the port imports nothing of the JAX package.
`tests/test_torch_port_hygiene.py` holds `to_dict()` of every registered name
equal between the two copies: a change to one must be made to both. Field
comments still name the JAX package's modules, where each option is defined.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class _Base:
    def to_dict(self) -> Dict[str, Any]:
        # dataclasses.asdict already deep-converts nested dataclasses.
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def config_hash(self) -> str:
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MoLConfig(_Base):
    """Mixture-of-Logits similarity config.

    Mirrors `create_mol_interaction_module` gin surface
    (`reference/modeling/similarity_utils.py:42-70`).
    """

    query_embedding_dim: int = 50
    item_embedding_dim: int = 50
    dot_product_dimension: int = 64          # d_P
    query_dot_product_groups: int = 8        # P_Q (incl. uid components)
    item_dot_product_groups: int = 4         # P_X
    temperature: float = 0.05
    dot_product_l2_norm: bool = True
    # Query-side projection MLP.
    query_hidden_dim: int = 512              # <=0 -> single Linear
    query_dropout_rate: float = 0.0
    query_nonlinearity: str = "swiglu"       # "geglu" | "swiglu"
    # Per-user ("uid") hash-embedding components appended to the query side
    # (`reference/rails/similarities/mol/query_embeddings_fns.py:162-170`).
    uid_embedding_hash_sizes: Tuple[int, ...] = ()
    uid_dropout_rate: float = 0.5
    uid_embedding_level_dropout: bool = False
    # Item-side projection MLP.
    item_hidden_dim: int = -1                # <=0 -> single Linear
    item_dropout_rate: float = 0.1
    item_nonlinearity: str = "swiglu"
    # Gating network.
    gating_query_fn: bool = True
    gating_item_fn: bool = True
    gating_query_hidden_dim: int = 128
    gating_item_hidden_dim: int = 128
    gating_qi_hidden_dim: int = 128          # <=0 -> single Linear
    gating_item_dropout_rate: float = 0.0
    gating_qi_dropout_rate: float = 0.0
    gating_combination_type: str = "glu_silu"  # "glu_silu" | "glu_silu_ln" | "none"
    softmax_dropout_rate: float = 0.2
    eps: float = 1e-6
    bf16_training: bool = False

    @property
    def num_logits(self) -> int:
        return self.query_dot_product_groups * self.item_dot_product_groups

    @property
    def query_proj_groups(self) -> int:
        """Query groups produced by the projection MLP (excluding uid groups)."""
        return self.query_dot_product_groups - len(self.uid_embedding_hash_sizes)

    def debug_str(self) -> str:
        s = (
            f"MoL-{self.query_dot_product_groups}x{self.item_dot_product_groups}"
            f"x{self.dot_product_dimension}-t{self.temperature}"
            f"-d{self.softmax_dropout_rate}"
            f"{'-l2' if self.dot_product_l2_norm else ''}"
        )
        if self.query_hidden_dim > 0:
            s += f"-q{self.query_hidden_dim}d{self.query_dropout_rate}{self.query_nonlinearity}"
        else:
            s += f"-cd{self.query_dropout_rate}"
        if self.item_hidden_dim > 0:
            s += f"-{self.item_hidden_dim}d{self.item_dropout_rate}{self.item_nonlinearity}"
        else:
            s += f"-id{self.item_dropout_rate}"
        if self.gating_query_fn:
            s += f"-gq{self.gating_query_hidden_dim}"
        if self.gating_item_fn:
            s += f"-gi{self.gating_item_hidden_dim}d{self.gating_item_dropout_rate}"
        s += f"-gqi{self.gating_qi_hidden_dim}d{self.gating_qi_dropout_rate}-x-{self.gating_combination_type}"
        if self.uid_embedding_hash_sizes:
            s += "-uids" + "-".join(str(x) for x in self.uid_embedding_hash_sizes)
            if self.uid_dropout_rate > 0.0:
                s += f"d{self.uid_dropout_rate}"
            if self.uid_embedding_level_dropout:
                s += "-el"
        return s


@dataclass(frozen=True)
class DotProductConfig(_Base):
    """Plain MIPS similarity (`reference/rails/similarities/dot_product_similarity_fn.py:24-68`)."""

    def debug_str(self) -> str:
        return "dp"


@dataclass(frozen=True)
class HSTUConfig(_Base):
    """HSTU encoder config (`reference/modeling/sequential/encoder_utils.py:67-110`)."""

    embedding_dim: int = 50
    num_blocks: int = 8
    num_heads: int = 2
    dqk: int = 25                            # attention dim per head
    dv: int = 25                             # linear/value dim per head
    linear_dropout_rate: float = 0.2
    attn_dropout_rate: float = 0.0
    linear_activation: str = "silu"          # "silu" | "none"
    normalization: str = "rel_bias"          # "rel_bias" | "softmax_rel_bias"
    concat_ua: bool = False
    enable_relative_attention_bias: bool = True
    num_time_buckets: int = 128
    epsilon: float = 1e-6
    # Serve/eval with the fully-fused Pallas block kernel
    # (rails_tpu/ops/pallas/hstu_block.py).
    fused_inference: bool = False
    # Train with the fused forward+backward block kernels
    # (rails_tpu/ops/pallas/hstu_block_train.py, custom VJP). Covers every
    # block variant (silu/none, rel_bias/softmax_rel_bias, concat_ua,
    # attention dropout). Dropout uses a deterministic counter-based hash
    # stream instead of flax's PRNG — a different (equally valid) dropout
    # realization.
    fused_train: bool = False

    def debug_str(self) -> str:
        s = (
            f"HSTU-b{self.num_blocks}-h{self.num_heads}-dqk{self.dqk}-dv{self.dv}"
            f"-l{self.linear_activation}d{self.linear_dropout_rate}"
            f"-ad{self.attn_dropout_rate}"
        )
        if not self.enable_relative_attention_bias:
            s += "-norab"
        return s


@dataclass(frozen=True)
class SASRecConfig(_Base):
    """SASRec encoder config (`reference/modeling/sequential/encoder_utils.py:34-65`)."""

    embedding_dim: int = 50
    num_blocks: int = 2
    num_heads: int = 1
    ffn_hidden_dim: int = 64
    ffn_activation_fn: str = "relu"
    ffn_dropout_rate: float = 0.2

    def debug_str(self) -> str:
        return (
            f"SASRec-b{self.num_blocks}-h{self.num_heads}-ffn{self.ffn_hidden_dim}"
            f"-d{self.ffn_dropout_rate}"
        )


@dataclass(frozen=True)
class DataConfig(_Base):
    """Dataset config (`reference/data/reco_dataset.py:39-160`)."""

    dataset_name: str = "ml-1m"
    max_sequence_length: int = 200
    chronological: bool = True
    positional_sampling_ratio: float = 1.0
    # Synthetic-dataset knobs (used when dataset_name == "synthetic").
    synthetic_num_users: int = 8192
    synthetic_num_items: int = 20000
    synthetic_seed: int = 0
    # 0 -> max_sequence_length + 2 (sequences actually fill the configured
    # geometry; an earlier silent 64-event cap made "n=200" runs mostly
    # padding).
    synthetic_max_len: int = 0
    synthetic_length_distribution: str = "uniform"   # | "ml20m"


@dataclass(frozen=True)
class TrainConfig(_Base):
    """Training loop config (`reference/train.py:108-149`)."""

    local_batch_size: int = 128
    eval_batch_size: int = 128
    num_epochs: int = 101
    learning_rate: float = 1e-3
    weight_decay: float = 1e-3
    num_warmup_steps: int = 0
    beta1: float = 0.9
    beta2: float = 0.98
    # Loss.
    loss_module: str = "SampledSoftmaxLoss"  # | "BCELoss"
    num_negatives: int = 128
    temperature: float = 1.0                 # sampled-softmax temperature
    loss_weights: Tuple[Tuple[str, float], ...] = ()
    loss_activation_checkpoint: bool = False  # remat the negatives scoring
    sampling_strategy: str = "local"         # | "in-batch"
    # One negative set per batch instead of per position (throughput
    # optimization beyond the reference; changes the estimator — A/B first).
    shared_negatives: bool = False
    # Score the shared negatives through the fused Pallas MoL pipeline
    # (custom VJP; in-kernel hash-stream dropout — a different, valid
    # realization than the XLA path's flax PRNG). Requires shared_negatives,
    # a local sampler, and the glu_silu gating configuration; other configs
    # fall back to the XLA path.
    fused_mol_loss: bool = False
    item_l2_norm: bool = False
    l2_norm_eps: float = 1e-6
    # Input/output processing.
    dropout_rate: float = 0.2                # input preproc dropout
    user_embedding_norm: str = "layer_norm"  # | "l2_norm"
    item_embedding_dim: int = 50
    gr_output_length: int = 10
    # Eval.
    top_k_method: str = "MoLBruteForceTopK"
    eval_interval: int = 100
    full_eval_every_n: int = 1
    partial_eval_num_iters: int = 32
    save_ckpt_every_n: int = 1000
    # One fused AdamW pass (K7, one launch a step) over the large leaves,
    # optax.adamw's math: 0.0963 ms for ML-20M's two fused leaves on an
    # NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6). The optimizer
    # state keeps one layout under both settings, so checkpoints restore
    # across this flag.
    fused_optimizer: bool = True
    # Binned scatter-add (K6) for the item-table gradient (the backward of
    # every `table[ids]` gather), the same dense gradient in f32; off, the
    # gradient goes through torch's indexing backward. Opt-in: at Books
    # scale K6 takes 0.1637 ms to `index_add_`'s 0.0738 on an NVIDIA H100
    # 80GB HBM3 at 700 W (PERF.md section 6).
    pallas_scatter_grad: bool = False
    # Precision.
    main_module_bf16: bool = False
    eval_bf16: bool = False
    # Misc.
    random_seed: int = 42


@dataclass(frozen=True)
class MeshConfig(_Base):
    """Device-mesh layout for pjit/shard_map execution.

    Replaces the reference's NCCL/DDP process-group setup
    (`reference/train.py:83-92`). `data` shards the batch dimension,
    `item` shards the candidate corpus for distributed top-k.
    """

    data_axis: str = "data"
    item_axis: str = "item"
    slice_axis: str = "slice"
    data_parallel: int = -1   # -1: all devices
    item_parallel: int = 1
    # Multi-slice pods: an outermost pure-data-parallel axis over DCN
    # (gradients all-reduce across slices once per step; the corpus and all
    # within-slice collectives stay on ICI). 1 = single slice (2-D mesh).
    num_slices: int = 1


@dataclass(frozen=True)
class ExperimentConfig(_Base):
    name: str = "default"
    model_type: str = "HSTU"                 # | "SASRec"
    similarity_type: str = "MoL"             # | "DotProduct"
    # Input-preprocessor / embedding-module selection, mirroring the
    # reference's gin-selectable modules
    # (`reference/modeling/sequential/encoder_utils.py:33-148`,
    # `input_features_preprocessors.py:94-267`, `embedding_modules.py:76-112`).
    input_preprocessor_type: str = "positional"   # | "rated" | "combined"
    embedding_module_type: str = "local"          # | "categorical"
    rating_embedding_dim: int = 8                 # rated preprocessor only
    num_ratings: int = 6                          # rating vocabulary (0..5)
    num_item_categories: int = 0                  # categorical module only
    mol: MoLConfig = field(default_factory=MoLConfig)
    hstu: HSTUConfig = field(default_factory=HSTUConfig)
    sasrec: SASRecConfig = field(default_factory=SASRecConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def model_debug_str(self) -> str:
        enc = self.hstu.debug_str() if self.model_type == "HSTU" else self.sasrec.debug_str()
        sim = self.mol.debug_str() if self.similarity_type == "MoL" else "dp"
        return f"{enc}_{sim}"

    @property
    def max_seq_len_padded(self) -> int:
        """Total padded sequence length N = history + generative output slots + 1."""
        return self.data.max_sequence_length + self.train.gr_output_length + 1


def _ml_1m_hstu_mol() -> ExperimentConfig:
    """configs/ml-1m/hstu-mol-sampled-softmax-n128-8x4x64-rails-final.gin:24-87."""
    return ExperimentConfig(
        name="ml-1m-hstu-mol-8x4x64",
        model_type="HSTU",
        similarity_type="MoL",
        mol=MoLConfig(
            query_embedding_dim=50,
            item_embedding_dim=50,
            dot_product_dimension=64,
            query_dot_product_groups=8,
            item_dot_product_groups=4,
            query_hidden_dim=512,
            query_dropout_rate=0.0,
            query_nonlinearity="swiglu",
            uid_embedding_hash_sizes=(6040,),
            uid_dropout_rate=0.5,
            item_hidden_dim=-1,
            item_dropout_rate=0.1,
            item_nonlinearity="swiglu",
            temperature=0.05,
            softmax_dropout_rate=0.2,
            gating_qi_hidden_dim=128,
            gating_query_hidden_dim=128,
            gating_item_hidden_dim=128,
            gating_combination_type="glu_silu",
        ),
        hstu=HSTUConfig(
            embedding_dim=50, num_blocks=8, num_heads=2, dqk=25, dv=25,
            linear_dropout_rate=0.2,
        ),
        data=DataConfig(dataset_name="ml-1m", max_sequence_length=200),
        train=TrainConfig(
            local_batch_size=128,
            num_epochs=101,
            item_embedding_dim=50,
            dropout_rate=0.2,
            user_embedding_norm="layer_norm",
            loss_module="SampledSoftmaxLoss",
            loss_weights=(("uid_embedding_l2_norm", 0.1), ("mi_loss", 0.001)),
            num_negatives=128,
            sampling_strategy="local",
            temperature=1.0,
            top_k_method="MoLBruteForceTopK",
        ),
    )


def _ml_20m_hstu_mol() -> ExperimentConfig:
    """configs/ml-20m/hstu-mol-sampled-softmax-n128-8x4x128-rails-final.gin."""
    base = _ml_1m_hstu_mol()
    return base.replace(
        name="ml-20m-hstu-mol-8x4x128",
        mol=base.mol.replace(
            query_embedding_dim=256,
            item_embedding_dim=256,
            dot_product_dimension=128,
            uid_embedding_hash_sizes=(16384,),
            uid_dropout_rate=0.8,
            gating_qi_dropout_rate=0.1,
        ),
        hstu=HSTUConfig(
            embedding_dim=256, num_blocks=16, num_heads=8, dqk=32, dv=32,
            linear_dropout_rate=0.2,
            # Default-on after the 60-epoch fused-vs-XLA convergence A/B at
            # this exact geometry (dropout 0.2, clustered synthetic) showed
            # the fused kernels in-band at every full-eval point
            # (docs/STATUS.md round-3).
            fused_train=True,
        ),
        data=DataConfig(dataset_name="ml-20m", max_sequence_length=200),
        train=base.train.replace(
            item_embedding_dim=256, local_batch_size=128, num_epochs=151,
        ),
    )


def _amzn_books_hstu_mol() -> ExperimentConfig:
    """configs/amzn-books/hstu-mol-sampled-softmax-n512-8x8x32-rails-final.gin."""
    base = _ml_1m_hstu_mol()
    return base.replace(
        name="amzn-books-hstu-mol-8x8x32",
        mol=base.mol.replace(
            query_embedding_dim=64,
            item_embedding_dim=64,
            dot_product_dimension=32,
            query_dot_product_groups=8,
            item_dot_product_groups=8,
            query_nonlinearity="geglu",
            item_nonlinearity="geglu",
            uid_embedding_hash_sizes=(),
            bf16_training=True,
        ),
        hstu=HSTUConfig(
            embedding_dim=64, num_blocks=16, num_heads=8, dqk=8, dv=8,
            linear_dropout_rate=0.5,
        ),
        data=DataConfig(dataset_name="amzn-books", max_sequence_length=50),
        train=base.train.replace(
            item_embedding_dim=64,
            local_batch_size=64,
            eval_batch_size=64,
            num_negatives=512,
            num_epochs=201,
            loss_weights=(("mi_loss", 0.001),),
            main_module_bf16=True,
            eval_bf16=True,
            dropout_rate=0.5,
            eval_interval=4000,
            full_eval_every_n=5,
            save_ckpt_every_n=5,
        ),
    )


def _synthetic_small() -> ExperimentConfig:
    """Small synthetic config for tests / smoke training on one chip."""
    base = _ml_1m_hstu_mol()
    return base.replace(
        name="synthetic-small",
        mol=base.mol.replace(
            query_embedding_dim=32,
            item_embedding_dim=32,
            dot_product_dimension=16,
            query_dot_product_groups=4,
            item_dot_product_groups=2,
            query_hidden_dim=64,
            uid_embedding_hash_sizes=(128,),
            gating_qi_hidden_dim=32,
            gating_query_hidden_dim=32,
            gating_item_hidden_dim=32,
        ),
        hstu=HSTUConfig(embedding_dim=32, num_blocks=2, num_heads=2, dqk=16, dv=16),
        sasrec=SASRecConfig(embedding_dim=32, num_blocks=2, num_heads=1, ffn_hidden_dim=32),
        data=DataConfig(
            dataset_name="synthetic",
            max_sequence_length=32,
            synthetic_num_users=512,
            synthetic_num_items=1000,
        ),
        train=base.train.replace(
            local_batch_size=32,
            eval_batch_size=32,
            item_embedding_dim=32,
            num_negatives=32,
            num_epochs=3,
            gr_output_length=2,
        ),
    )


def _sasrec_variant(base: ExperimentConfig, num_blocks: int, num_heads: int,
                    ffn_hidden_dim: int, ffn_dropout: float,
                    train_kw: Optional[Dict[str, Any]] = None,
                    mol_kw: Optional[Dict[str, Any]] = None) -> ExperimentConfig:
    """SASRec+MoL variants (`configs/*/sasrec-mol-*.gin`): SASRec encoder,
    weight decay 0, same MoL geometry as the HSTU variant. `train_kw` /
    `mol_kw` carry the per-dataset bindings the gin files change vs the HSTU
    base (pinned by tests/test_gin_import.py against the gin files)."""
    cfg = base.replace(
        name=base.name.replace("hstu", "sasrec"),
        model_type="SASRec",
        sasrec=SASRecConfig(
            embedding_dim=base.train.item_embedding_dim,
            num_blocks=num_blocks,
            num_heads=num_heads,
            ffn_hidden_dim=ffn_hidden_dim,
            ffn_dropout_rate=ffn_dropout,
            ffn_activation_fn="relu",
        ),
        train=base.train.replace(weight_decay=0.0, **(train_kw or {})),
    )
    if mol_kw:
        cfg = cfg.replace(mol=cfg.mol.replace(**mol_kw))
    return cfg


def _dot_product_variant(
    base: ExperimentConfig, train_kw: Optional[Dict[str, Any]] = None
) -> ExperimentConfig:
    """Dot-product sampled-softmax baselines (`configs/*/hstu-sampled-softmax-*.gin`):
    l2-normed user/item embeddings, temperature 0.05, MIPS top-k. `train_kw`
    carries per-dataset bindings the gin files change vs the MoL base."""
    return base.replace(
        name=base.name.split("-mol")[0] + "-dot",
        similarity_type="DotProduct",
        train=base.train.replace(
            user_embedding_norm="l2_norm",
            temperature=0.05,
            item_l2_norm=True,
            top_k_method="MIPSBruteForceTopK",
            loss_weights=(),
            **(train_kw or {}),
        ),
    )


def _fast_variant(base: ExperimentConfig) -> ExperimentConfig:
    """The throughput stack on top of a published MoL config: shared
    negatives (ONE R-set per batch instead of per position — quality parity
    A/B'd in docs/STATUS.md, estimator change flagged in
    `losses/sampled_softmax.py`) + the fused MoL-loss kernel (K5,
    `ops/mol_loss_train.py`). On an NVIDIA H100 80GB HBM3 at 700 W,
    `cli.train_bench` (B=128) steps ml-20m-hstu-mol-fast with
    `pallas_scatter_grad` in 125.6 ms against ml-20m-hstu-mol's 368.0 in one
    run, and in 147.2 ms in another: the `-fast` step is host-bound (PERF.md
    section 5). The plain config keeps the reference's per-position
    estimator semantics; pick `-fast` for throughput-bound training."""
    return base.replace(
        name=base.name + "-fast",
        train=base.train.replace(shared_negatives=True, fused_mol_loss=True),
    )


_REGISTRY = {
    "ml-1m-hstu-mol": _ml_1m_hstu_mol,
    "ml-20m-hstu-mol": _ml_20m_hstu_mol,
    "amzn-books-hstu-mol": _amzn_books_hstu_mol,
    "ml-1m-sasrec-mol": lambda: _sasrec_variant(_ml_1m_hstu_mol(), 2, 1, 50, 0.2),
    # ml-20m sasrec-mol gin additionally turns on bf16 eval + bf16 MoL
    # training (`configs/ml-20m/sasrec-mol-...gin`: eval_bf16/bf16_training).
    "ml-20m-sasrec-mol": lambda: _sasrec_variant(
        _ml_20m_hstu_mol(), 4, 4, 256, 0.2,
        train_kw={"eval_bf16": True}, mol_kw={"bf16_training": True},
    ),
    # Books sasrec gins differ from the HSTU base: fp32 main module,
    # partial_eval_num_iters 64, save_ckpt_every_n 10.
    "amzn-books-sasrec-mol": lambda: _sasrec_variant(
        _amzn_books_hstu_mol(), 4, 4, 64, 0.5,
        train_kw={"partial_eval_num_iters": 64, "save_ckpt_every_n": 10,
                  "main_module_bf16": False},
    ),
    "ml-1m-hstu-dot": lambda: _dot_product_variant(_ml_1m_hstu_mol()),
    # The ml-20m / books dot gins zero the weight decay (the ml-1m one keeps
    # 1e-3); the books one also runs batch 128 in fp32-eval with default ckpt
    # cadence.
    "ml-20m-hstu-dot": lambda: _dot_product_variant(
        _ml_20m_hstu_mol(), train_kw={"weight_decay": 0.0}
    ),
    "amzn-books-hstu-dot": lambda: _dot_product_variant(
        _amzn_books_hstu_mol(),
        train_kw={"local_batch_size": 128, "eval_batch_size": 128,
                  "weight_decay": 0.0, "save_ckpt_every_n": 1000,
                  "eval_bf16": False},
    ),
    "ml-1m-sasrec-dot": lambda: _dot_product_variant(
        _sasrec_variant(_ml_1m_hstu_mol(), 2, 1, 50, 0.2)
    ),
    "ml-20m-sasrec-dot": lambda: _dot_product_variant(
        _sasrec_variant(_ml_20m_hstu_mol(), 4, 4, 256, 0.2)
    ),
    "amzn-books-sasrec-dot": lambda: _dot_product_variant(
        _sasrec_variant(
            _amzn_books_hstu_mol(), 4, 4, 64, 0.5,
            train_kw={"partial_eval_num_iters": 64, "save_ckpt_every_n": 10,
                      "main_module_bf16": False},
        ),
        train_kw={"local_batch_size": 128, "eval_batch_size": 128,
                  "eval_bf16": False},
    ),
    "ml-1m-hstu-mol-fast": lambda: _fast_variant(_ml_1m_hstu_mol()),
    "ml-20m-hstu-mol-fast": lambda: _fast_variant(_ml_20m_hstu_mol()),
    "amzn-books-hstu-mol-fast": lambda: _fast_variant(_amzn_books_hstu_mol()),
    "synthetic-small": _synthetic_small,
}


def get_experiment_config(name: str) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown experiment {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_experiment_configs() -> List[str]:
    return sorted(_REGISTRY)

"""Config dataclasses of the PyTorch port.

A copy of the reference's ``repro/configs/base.py`` restricted to what
the ported paths read (RNN-T, dense and MoE decoder-LM, RWKV6, the
RG-LRU hybrid, the encoder-decoder and the VLM prefix, training + PGM
selection + serving): the field names, defaults and the smoke reduction
are the reference's, so a config built here and one built there
describe the same model and run.  Fields of later slices (mesh,
compression) are not carried.  The dry run's shapes (``ShapeConfig``,
``SHAPES``) are the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer-stack patterns: ``pattern * (n_layers // len(pattern))`` followed
# by ``pattern[:n_layers % len(pattern)]``.
BLOCK_ATTN = "attn"          # full causal attention
BLOCK_LOCAL = "local"        # sliding-window attention
BLOCK_GLOBAL = "global"      # full attention inside a hybrid stack
BLOCK_REC = "rec"            # RG-LRU recurrent block (Griffin)
BLOCK_RWKV = "rwkv"          # RWKV6 time-mix + channel-mix block
ATTN_KINDS = (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_GLOBAL)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class RNNTConfig:
    """Paper's own architecture: SpeechBrain Librispeech transducer recipe.

    CRDNN encoder (2 CNN blocks -> 4 bi-LSTM layers -> 2 DNN layers),
    prediction net (embedding + 1-layer GRU), joint = single linear
    projecting 1024-d fused representation to 1000 BPE vocab.
    """

    n_feats: int = 80
    cnn_channels: Tuple[int, int] = (64, 128)
    lstm_layers: int = 4
    lstm_hidden: int = 512           # per direction
    dnn_dim: int = 1024
    pred_embed: int = 256
    pred_hidden: int = 512
    joint_dim: int = 1024
    vocab_size: int = 1000           # BPE units + blank
    time_reduction: int = 4          # cnn striding
    # transducer-loss path: "fused" = the alpha/beta lattice over the
    # joint factors with a vocab-streamed joint (never materializes the
    # (B,T,U+1,V) tensor); "dense" = the autodiff parity oracle over the
    # materialized logits
    loss_impl: str = "fused"
    # vocab-chunk size of the fused loss's streamed logsumexp/backward
    # (0: auto-tuned at engine build, <0: one chunk of the whole vocab)
    loss_vocab_chunk: int = 0

    def n_params(self) -> int:
        n = 0
        c_in = 1
        for c in self.cnn_channels:
            n += c_in * c * 9 + c
            c_in = c
        d_in = self.cnn_channels[-1] * (self.n_feats // 4)
        for _ in range(self.lstm_layers):
            n += 2 * 4 * (d_in * self.lstm_hidden + self.lstm_hidden ** 2
                          + self.lstm_hidden)
            d_in = 2 * self.lstm_hidden
        n += d_in * self.dnn_dim + self.dnn_dim * self.dnn_dim
        n += self.vocab_size * self.pred_embed
        n += 3 * (self.pred_embed * self.pred_hidden + self.pred_hidden ** 2)
        n += (self.dnn_dim + self.pred_hidden) * self.joint_dim
        n += self.joint_dim * self.vocab_size
        return n


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (RNN-T and decoder LMs)."""

    name: str
    family: str                      # dense | moe | ssm (rwkv stacks) |
                                     # hybrid (rec + local) | encdec |
                                     # vlm | rnnt
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    ffn_type: str = "swiglu"         # swiglu | geglu | gelu | sq_relu
    pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    window: int = 0                  # sliding window of local blocks (0 = none)
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    # --- recurrent extras ---
    lru_width: int = 0               # RG-LRU width (0 = d_model)
    conv_width: int = 4              # RG-LRU temporal conv width
    rwkv_head_dim: int = 64
    # --- encoder-decoder extras ---
    n_enc_layers: int = 0
    # --- modality frontend stubs (audio / vlm) ---
    frontend: str = "none"           # none | audio_frames | image_patches
    n_prefix: int = 0                # frontend positions (e.g. patches)
    rnnt: Optional[RNNTConfig] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        reps = self.n_layers // len(self.pattern)
        rem = self.n_layers % len(self.pattern)
        return tuple(self.pattern) * reps + tuple(self.pattern[:rem])

    def is_subquadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts without an
        unbounded full-attention KV cache in every layer: recurrent or
        local layers only, local layers beside a few global ones
        (gemma3), or any recurrent layer (the reference's rule)."""
        kinds = set(self.layer_kinds())
        if kinds <= {BLOCK_REC, BLOCK_RWKV, BLOCK_LOCAL}:
            return True
        if BLOCK_GLOBAL in kinds and BLOCK_LOCAL in kinds:
            return True
        return bool(kinds & {BLOCK_REC, BLOCK_RWKV})

    def n_params(self) -> int:
        """Analytic parameter count (embedding + stack + head), the
        reference's formula for RNN-T, dense and MoE attention stacks,
        RWKV6 stacks and the RG-LRU hybrid.  Its RWKV term is the
        reference's as written: it leaves out the channel-mix ``wr`` and
        most of the LoRA weights, so it is below the count of the params
        tree's leaves.  So is its ``rec`` term, which counts the in and
        out projections, the conv taps and three width vectors but not
        the GeLU branch's ``w_gate_branch`` nor the gates' ``wa`` and
        ``wx`` (d w + 2 w^2 a layer), nor the norms: recurrentgemma-9b
        has 9,396,408,320 leaves against its 8,087,363,584.  Its MoE
        term counts three expert matrices whatever the FFN type.  Its
        encoder term (``n_enc_layers``) counts each encoder layer's
        attention and FFN and one more attention for the decoder's
        cross-attention, but no norm: seamless-m4t-medium has
        614,739,968 leaves against its 614,676,480, paligemma-3b (a
        decoder stack) 2,508,662,784 against 2,508,587,008."""
        if self.rnnt is not None:
            return self.rnnt.n_params()
        kinds = self.layer_kinds()
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm") \
                or set(kinds) - set(ATTN_KINDS) - {BLOCK_RWKV, BLOCK_REC}:
            raise NotImplementedError(
                f"{self.name}: n_params is ported for attention stacks "
                f"(dense, MoE, encdec, vlm), RWKV6 stacks, the RG-LRU "
                f"hybrid and RNN-T only")
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = V * d * (1 if self.tie_embeddings else 2)
        mult = 3 if self.ffn_type in ("swiglu", "geglu") else 2
        for kind in kinds:
            if kind == BLOCK_RWKV:
                # r,k,v,g,o projections + decay lora + token-shift mus
                n += 5 * d * d + 2 * d * 96 + 6 * d
            elif kind == BLOCK_REC:
                w = self.lru_width or d
                # rg-lru block: in/out proj + conv + gates
                n += 2 * d * w + self.conv_width * w + 3 * w
            else:
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            # rec blocks in griffin also carry an MLP
            if self.moe is not None and kind != BLOCK_REC:
                e = self.moe
                n += e.n_experts * 3 * d * e.d_ff_expert + d * e.n_experts
            else:
                n += mult * d * ff
        for _ in range(self.n_enc_layers):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            # the decoder's cross attention, counted with the encoder
            n += attn + mult * d * ff + attn
        return n

    def n_active_params(self) -> int:
        """Active params a token (MoE: only ``top_k`` experts count)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        per_expert = len(self.layer_kinds()) * 3 * self.d_model \
            * e.d_ff_expert
        return self.n_params() - (e.n_experts - e.top_k) * per_expert


# ---------------------------------------------------------------------------
# Shapes of the dry run (the reference's, ``repro/configs/base.py``)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class PGMConfig:
    """Paper hyper-parameters (§5): selection interval R, partitions D,
    warm-start epochs, subset fraction, OMP regularization/tolerance."""

    subset_fraction: float = 0.3
    n_partitions: int = 8            # D; paper: 7 (100H) / 50 (960H)
    select_every: int = 5            # R
    warm_start_epochs: int = 2
    val_matching: bool = False       # 'Val' flag (noisy/robust mode)
    lam: float = 0.5                 # l2 reg on weights (lambda)
    eps: float = 1e-10               # OMP stopping tolerance
    sketch_dim_h: int = 64           # tensor-JL sketch dims
    sketch_dim_v: int = 64
    use_sketch: bool = True          # False -> exact last-layer gradients
    nonneg_weights: bool = True      # clip OMP weights at 0
    # sparse-expert (MoE) selection gradients: append the per-unit
    # gradient of the total loss (task + load-balance aux) with respect
    # to every router leaf, sketched on its d_model axis, to the head's
    # representation.  Opt-in (one autograd backward a unit); ignored
    # for other families
    moe_router_term: bool = False
    # selection-round kernels (grad sketch, Gram): "auto" and "pallas"
    # launch the CUDA kernels on the card, "xla" runs their plain
    # versions there; on the CPU every value runs the plain versions
    kernel_impl: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1.0
    optimizer: str = "sgd"           # sgd | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    epochs: int = 30
    # newbob: anneal lr by `anneal_factor` when the relative validation
    # improvement drops below `improvement_threshold`
    anneal_factor: float = 0.8
    improvement_threshold: float = 0.0025
    seed: int = 0
    # cross-pod gradient compression: when the training mesh carries a
    # `pod_axis` axis, the step averages the pods' gradients through
    # `train/compress.py:compressed_psum` -- "none" keeps that collective
    # dense fp32, "bf16" halves its wire width, "topk" sends the k
    # largest entries a leaf with error feedback kept in the engine
    compress_mode: str = "none"      # none | bf16 | topk
    compress_k_frac: float = 0.05    # top-k fraction a gradient leaf
    pod_axis: str = "pod"            # mesh axis name of the slow pod axis
    # fault tolerance: with `nonfinite_guard` the step checks its loss
    # and clipped gradient norm for NaN/Inf on the device and gates a
    # non-finite step into a bit-exact no-op (optim.gate_step) with no
    # host branch.  `max_skipped_steps` arms the host-side divergence
    # watchdog: K consecutive skipped steps (or a non-finite train/val
    # loss) roll the run back to the newest intact checkpoint with
    # re-keyed batch plans.  0 disables the consecutive-skip trigger.
    nonfinite_guard: bool = False
    max_skipped_steps: int = 0
    pgm: PGMConfig = field(default_factory=PGMConfig)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """The reference's tiny same-family variant (CPU tests): few layers,
    small widths and vocab, a window of at most 16, an RG-LRU width of
    64, 2 encoder layers, a prefix of 8, 4 experts of 32 (top at most
    2), fp32 compute."""
    kw = dict(n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.pattern))),
              d_model=64, n_heads=4,
              n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
              head_dim=16, d_ff=128, vocab_size=277,
              window=min(cfg.window, 16) if cfg.window else 0,
              lru_width=64 if cfg.lru_width else 0,
              n_enc_layers=2 if cfg.n_enc_layers else 0,
              n_prefix=8 if cfg.n_prefix else 0,
              compute_dtype="float32")
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=32)
    if cfg.rnnt is not None:
        kw["rnnt"] = RNNTConfig(
            n_feats=8, cnn_channels=(4, 8), lstm_layers=1, lstm_hidden=16,
            dnn_dim=32, pred_embed=16, pred_hidden=16, joint_dim=32,
            vocab_size=37,
        )
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)

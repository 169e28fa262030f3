"""Config dataclasses: the LM architectures and the paper's 3D ConvNets.

Two config families, copied from the reference's ``configs/base.py``:
  * ``ModelConfig``   — LM-family architectures (dense / MoE / SSM / hybrid /
    enc-dec through a ``block_pattern`` of layer tokens).  The port serves
    the dense decoder-only ones so far (``configs/__init__.py``).
  * ``ConvNetConfig`` — the paper's 3D sliding-window ConvNets (Table III).

Everything is a frozen dataclass, so configs are hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-token grammar for ``block_pattern``
#
#   attn        full (causal) GQA attention block
#   local       sliding-window GQA attention block (window = swa_window)
#   global      full attention block (used inside local/global interleaves)
#   mamba       Mamba2 SSD block
#   <tok>_moe   same mixer, MLP replaced by an MoE
# ---------------------------------------------------------------------------

VALID_MIXERS = ("attn", "local", "global", "mamba")


def parse_block_token(tok: str) -> Tuple[str, bool]:
    """Return (mixer_kind, is_moe) for a block-pattern token."""
    is_moe = tok.endswith("_moe")
    mixer = tok[: -len("_moe")] if is_moe else tok
    if mixer not in VALID_MIXERS:
        raise ValueError(f"unknown block token {tok!r}")
    return mixer, is_moe


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_kind: str = "rope"  # 'rope' | 'mrope' | 'none'
    swa_window: Optional[int] = None  # used by 'local' blocks (and SWA archs)
    # mrope sections (temporal, height, width) fractions of head_dim/2
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # group-preserving q-head padding (beyond-paper sharding lever): pad the
    # per-kv-head query group from q_per_kv to `pad_q_groups` with ZERO
    # heads so n_heads_eff = n_kv_heads * pad_q_groups becomes divisible by
    # the model axis.  Padded heads contribute nothing (zero wq AND zero wo
    # rows; gradients stay zero) — outputs are bit-identical, but attention
    # activations/weights become shardable.  See EXPERIMENTS.md §Perf H1.
    pad_q_groups: Optional[int] = None
    # expand kv heads to full H inside attention (GSPMD-friendly when the
    # model axis divides H but not (Hkv, G) separately) — §Perf H1 lever.
    expand_kv: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_heads_eff(self) -> int:
        if self.pad_q_groups is None:
            return self.n_heads
        assert self.pad_q_groups >= self.q_per_kv
        return self.n_kv_heads * self.pad_q_groups


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # router aux-loss weight for training
    aux_loss_weight: float = 0.01
    # GShard-style expert capacity = cf * T * K / E; tokens beyond capacity
    # are dropped.  Set cf >= n_experts for drop-free routing (tests).
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...]
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): decoder uses block_pattern; encoder is
    # n_enc_layers of full attention over enc_seq precomputed frames.
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0
    frontend: str = "none"  # none | patch | audio  (stub frontends per spec)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # decode-time activation replication (serve lever, §Perf H3): with
    # 2-axis-sharded weights, replicated activations make GSPMD psum tiny
    # activation partials instead of circulating huge weight shards.
    decode_replicate_activations: bool = False
    # MoE dispatch routing groups (shard-local routing when == dp degree;
    # see layers/moe.py and EXPERIMENTS.md §Perf H2)
    moe_routing_groups: int = 1
    # sub-quadratic in sequence length => long_500k cell runs
    sub_quadratic: bool = False
    notes: str = ""

    # -- derived ------------------------------------------------------------
    def mixer_counts(self) -> dict:
        """How many layers of each mixer kind / how many MoE layers."""
        counts = {"attn": 0, "local": 0, "global": 0, "mamba": 0, "moe": 0}
        for i in range(self.n_layers):
            mixer, is_moe = parse_block_token(
                self.block_pattern[i % len(self.block_pattern)]
            )
            counts[mixer] += 1
            counts["moe"] += int(is_moe)
        return counts

    def param_count(self) -> int:
        """Total parameter count (embedding included)."""
        d = self.d_model
        c = self.mixer_counts()
        n = 0
        # embeddings (+ untied head)
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.attn is not None:
            a = self.attn
            qkv = d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim
            if a.qkv_bias:
                qkv += (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
            out = a.n_heads * a.head_dim * d
            n += (c["attn"] + c["local"] + c["global"]) * (qkv + out)
        if c["mamba"] and self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_ssm_heads(d)
            per = (
                d * (2 * di + 2 * s.d_state + nh)  # in_proj (x,z,B,C,dt)
                + s.d_conv * (di + 2 * s.d_state)  # conv1d
                + nh  # A_log
                + nh  # D
                + di * d  # out_proj
            )
            n += c["mamba"] * per
        # MLPs: swiglu = 3 mats, gelu = 2
        mats = 3 if self.act == "swiglu" else 2
        dense_mlp_layers = self.n_layers - c["moe"]
        n += dense_mlp_layers * mats * d * self.d_ff
        if self.moe is not None and c["moe"]:
            per = self.moe.n_experts * mats * d * self.d_ff + d * self.moe.n_experts
            n += c["moe"] * per
        # norms (2 per layer) + final norm
        n += (2 * self.n_layers + 1) * d
        if self.enc_dec:
            # encoder layers: attn + mlp, plus decoder cross-attn already
            # counted? no — cross attention adds qkv+out per decoder layer.
            a = self.attn
            enc_per = (
                d * a.n_heads * a.head_dim
                + 2 * d * a.n_kv_heads * a.head_dim
                + a.n_heads * a.head_dim * d
                + mats * d * self.d_ff
                + 2 * d
            )
            n += self.n_enc_layers * enc_per
            cross_per = (
                d * a.n_heads * a.head_dim
                + 2 * d * a.n_kv_heads * a.head_dim
                + a.n_heads * a.head_dim * d
                + d
            )
            n += self.n_layers * cross_per
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        c = self.mixer_counts()
        mats = 3 if self.act == "swiglu" else 2
        full = self.param_count()
        inactive_experts = self.moe.n_experts - self.moe.top_k
        inactive = c["moe"] * inactive_experts * mats * self.d_model * self.d_ff
        return full - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat_len = len(self.block_pattern)
        n_layers = max(pat_len, 2) if pat_len > 1 else 2
        attn = None
        if self.attn is not None:
            a = self.attn
            attn = dataclasses.replace(
                a,
                n_heads=4,
                n_kv_heads=max(1, min(4, 4 * a.n_kv_heads // max(a.n_heads, 1))),
                head_dim=16,
                swa_window=16 if a.swa_window else None,
                mrope_sections=(2, 3, 3),  # sums to head_dim // 2
            )
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=min(2, self.moe.top_k))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=8, headdim=8, chunk=8)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            d_ff=128,
            vocab=256,
            attn=attn,
            moe=moe,
            ssm=ssm,
            n_enc_layers=2 if self.enc_dec else 0,
            enc_seq=16 if self.enc_dec else 0,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned; LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) runs, per DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full attention (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# ZNNi 3D ConvNets (paper Table III)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvLayerSpec:
    kind: str  # 'conv' | 'pool'
    size: int  # kernel size k (conv) or pooling window p (pool)
    out_channels: int = 0  # conv only


@dataclass(frozen=True)
class ConvNetConfig:
    name: str
    in_channels: int
    layers: Tuple[ConvLayerSpec, ...]

    def field_of_view(self) -> int:
        """FOV of the sliding window (1D extent; isotropic)."""
        fov, stride = 1, 1
        for l in self.layers:
            if l.kind == "conv":
                fov += (l.size - 1) * stride
            else:
                fov += (l.size - 1) * stride
                stride *= l.size
        return fov

    def total_pooling(self) -> int:
        p = 1
        for l in self.layers:
            if l.kind == "pool":
                p *= l.size
        return p

    def valid_input_size(self, n_out: int) -> int:
        """Smallest input size that yields >= n_out output voxels per axis.

        Walks the net backwards: conv adds k-1; MPF pooling needs n ≡ p-1 (mod p)
        i.e. n = p*m + (p-1) to produce fragments of size m.
        """
        n = n_out
        for l in reversed(self.layers):
            if l.kind == "conv":
                n = n + l.size - 1
            else:
                n = l.size * n + l.size - 1
        return n

    def output_size(self, n_in: int) -> int:
        """Output voxels per axis for input size n_in (MPF fragments)."""
        n = n_in
        for l in self.layers:
            if l.kind == "conv":
                n = n - l.size + 1
            else:
                if (n + 1) % l.size != 0:
                    return -1  # invalid input size
                n = n // l.size
        return n

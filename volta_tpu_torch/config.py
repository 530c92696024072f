"""The port's model configuration, a copy of ``volta_tpu/config.py``.

It keeps every field of the JAX package's ``VoltaConfig``, the TPU-only ones
included, with the same defaults, so every ``configs/*.json`` loads
unchanged and gives the same ``sublayer_plan()``. Comments marked "port:"
say what a field means in ``volta_tpu_torch``; the names stay those of the
JSON schema. The module uses the standard library only.

A single config object describes the whole family of gated bimodal encoders
(ViLBERT / LXMERT / VL-BERT / VisualBERT / UNITER and their CTRL variants).
The JSON schema is kept compatible with the reference framework
(reference: volta/config.py:11-181) so existing ``config/*.json`` files load
verbatim, but the implementation is a typed dataclass with derived, static
layer plans that the Flax modules consume at construction time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


def _intkeys(d: Dict[Any, Any]) -> Dict[str, Any]:
    """Normalise sublayer-override dict keys to str (JSON round-trip safe)."""
    return {str(k): v for k, v in (d or {}).items()}


@dataclasses.dataclass
class VoltaConfig:
    """Architecture config for the gated bimodal encoder.

    Field semantics mirror the reference JSON schema
    (reference: volta/config.py:15-64): text-side sizes, vision-side ``v_*``
    sizes, and the sublayer gating lists that *are* the model definition.
    """

    # --- Text side -------------------------------------------------------
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    pooler_size: int = 768
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # --- Vision side ------------------------------------------------------
    num_locs: int = 5
    v_coordinate_embeddings_dim: Optional[int] = None
    add_global_imgfeat: Optional[str] = None  # None | "first" | "last"
    image_embeddings: str = "vilbert"
    v_feature_size: int = 2048
    v_hidden_size: int = 768
    v_num_attention_heads: int = 12
    v_intermediate_size: int = 3072
    v_pooler_size: int = 1024
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.2
    # --- Sublayer gating (the model definition) ---------------------------
    tt_attn_sublayers: List[int] = dataclasses.field(default_factory=list)
    tv_attn_sublayers: List[int] = dataclasses.field(default_factory=list)
    vt_attn_sublayers: List[int] = dataclasses.field(default_factory=list)
    vv_attn_sublayers: List[int] = dataclasses.field(default_factory=list)
    t_ff_sublayers: List[int] = dataclasses.field(default_factory=list)
    v_ff_sublayers: List[int] = dataclasses.field(default_factory=list)
    shared_sublayers: List[int] = dataclasses.field(default_factory=list)
    single_ln_sublayers: List[int] = dataclasses.field(default_factory=list)
    sublayer2attn_hidden_size: Dict[str, int] = dataclasses.field(default_factory=dict)
    sublayer2num_attention_heads: Dict[str, int] = dataclasses.field(default_factory=dict)
    sublayer2intermediate_size: Dict[str, int] = dataclasses.field(default_factory=dict)
    sublayer2v_attn_hidden_size: Dict[str, int] = dataclasses.field(default_factory=dict)
    sublayer2v_num_attention_heads: Dict[str, int] = dataclasses.field(default_factory=dict)
    sublayer2v_intermediate_size: Dict[str, int] = dataclasses.field(default_factory=dict)
    bert_layer2attn_sublayer: Dict[str, int] = dataclasses.field(default_factory=dict)
    bert_layer2ff_sublayer: Dict[str, int] = dataclasses.field(default_factory=dict)
    image_head_ln: bool = True
    # --- Misc --------------------------------------------------------------
    visual_target_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"0": 1.0}
    )
    fixed_layers: List[str] = dataclasses.field(default_factory=list)
    fusion_method: str = "mul"  # sum|mul|text|vl-bert_vqa|none
    objective: int = 0
    clf_hidden_size: int = 1536
    model: str = "bert"  # bert | roberta
    # fairseq-intended RoBERTa positions (start at padding_idx+1=2). The
    # reference computes but DISCARDS these (volta/embeddings.py:55-57
    # overwrites; oracle-verified), so the as-shipped default is 0-based.
    roberta_position_offset: bool = False
    # Attention-map capture (reference: volta/encoders.py:190,342-358):
    # when set, every forward also returns per-attention-sublayer
    # {intra_attn, inter_attn, queries, keys} dicts in extras["probs"]
    # (same as calling with output_probs=True; eval_task --dump_attn
    # saves them to .npz).
    visualization: bool = False
    # --- TPU-native extensions (not in reference schema) -------------------
    # Compute dtype for the encoder ("float32" | "bfloat16"); params stay fp32.
    compute_dtype: str = "float32"
    # Use the Pallas fused attention kernel where available (wins on the
    # no-dropout/eval path; measured +18% eval throughput on v5e).
    # port: the attention always runs through the CUDA kernels; this flag
    # only gates use_fused_residual_ln, fuse_hidden_dropout and
    # use_pallas_dropout_mask, as it does in the JAX encoder.
    use_pallas: bool = True
    # Pallas fused LayerNorm (XLA's fused LN measured slightly faster at
    # BERT-base shapes, so off by default; flip for wider models).
    # port: every LayerNorm runs the CUDA LayerNorm kernels
    # (ops/csrc/layernorm.cu) instead of the plain torch LayerNorm.
    use_pallas_layernorm: bool = False
    # lax.scan over the homogeneous single-stream stack. Same numerics
    # (deterministic mode bit-equal); measured on v5e: no compile-time win
    # (remote-compile overhead dominates) and ~26% slower steps, so off by
    # default — useful only when trace size/memory is the constraint.
    use_scan: bool = False
    # Rematerialise the feed-forward sublayers in the backward pass
    # (recompute the up-projection + GELU instead of saving the [B, L, 4H]
    # activation). Never applied to the dropout-attention kernel — its
    # Mosaic PRNG draws are not reproducible across recompilations, so
    # recompute there would decorrelate the mask from the forward pass.
    # port: not ported yet (ROADMAP.md Queue 1 item 2); true raises.
    remat_ff: bool = False
    # Fused dropout+residual+LayerNorm train kernel for the sublayer tails
    # (ops/fused_residual.py). Measured A/B on v5e (b256 seq23 r37 VQA
    # step): 93.8 ms fused vs 92.3 ms XLA — XLA already fuses the
    # dropout+add+LN chain into the matmul epilogues, so the kernel is a
    # slight non-win at base shapes and stays opt-in (same story as the
    # Pallas LN). Only active on the TPU train path (rate > 0).
    # port: with use_pallas, the training-mode sublayer tails run the CUDA
    # dropout+residual+LayerNorm kernels (ops/csrc/fused_residual.cu), whose
    # mask is hash_dropout's bit for bit.
    use_fused_residual_ln: bool = False
    # Draw the two hidden-dropout keep masks of each attn+FFN sublayer pair
    # inside the Pallas dropout-attention kernel (whose per-program PRNG is
    # already seeded) instead of running an XLA RNG pass per dropout site.
    # Measured A/B on v5e (b256 VQA step): 95.9 ms with masks vs 92.8 ms
    # XLA bernoulli — the [H,B,L,D]->[B,L,H*D] mask transpose + extra HBM
    # round trips outweigh the saved RNG passes (XLA fuses bernoulli into
    # the matmul epilogues with zero extra traffic), so OFF by default;
    # kernel kept validated (tools/validate_tpu.py) for wider-model shapes
    # where the trade may flip.
    # port: with use_pallas, each training attention sublayer runs the CUDA
    # kernel of Queue 2 row 9 (ops/attention_hidden_mask_cuda.py), which
    # also writes the two tails' keep masks: hash_dropout's bits for the
    # seeds those tails would draw.
    fuse_hidden_dropout: bool = False
    # Generate the hidden-dropout keep masks with a dedicated Pallas kernel
    # (Mosaic hardware PRNG, lane-aligned bf16 writes) instead of XLA's
    # RngBitGenerator, which materialises a 47 MB uint32 bits tensor per
    # dropout site (~4.0 ms/step of the 7.4 ms hidden-dropout cost at b256).
    # The mask *apply* (multiply + residual + LN) stays in XLA where it
    # fuses into the matmul epilogues.
    # port: with use_pallas, each training sublayer tail draws its keep mask
    # with the CUDA kernel of Queue 2 row 14 (ops/dropout_mask.py):
    # hash_dropout's bits for the tail's seed.
    use_pallas_dropout_mask: bool = False
    # Counter-based hidden dropout: keep bit = murmur3-fmix32(position +
    # seed) < threshold — a pure function of (iota, seed) that XLA fuses
    # into the surrounding epilogue and rematerialises in the backward, so
    # there is no RNG bits tensor and no saved mask at all. Same
    # Bernoulli(1-rate) marginal as jax.random.bernoulli. Measured on v5e
    # (b256 VQA step): 88.5 ms vs 92.3 ms RngBitGenerator bernoulli vs
    # 91.4 ms Pallas mask kernel (which stays available via
    # use_pallas_dropout_mask as the draw-replay-safe alternative).
    # port: hash dropout is the port's only hidden dropout; false raises
    # (int_threshold_dropout, ROADMAP.md Queue 1 item 2).
    use_hash_dropout: bool = True
    # Natural-layout attention kernels: block the q/k/v arrays in their
    # native [B, L, H*D] projection-output layout (batch-only grid) and
    # carve the per-head [bt, L, D] tiles as in-VMEM lane slices, instead
    # of transposing to the head-major [H,B,L,D] layout. The head-major
    # path costs an XLA layout copy per q/k/v/g/context at every attention
    # site — ~13 ms/step (15%) at the b256 headline shapes, measured from
    # the round-3 profile trace (tools/analyze_trace.py). The odd-head lane
    # rotates the natural kernels pay instead stay in VMEM and replace
    # those HBM round trips. Hardware A/B (b256 VQA full step, 30 iters):
    # 77.15 ms vs 84.71 ms head-major → 3318 vs 3022 pairs/s (+9.8%), so
    # DEFAULT ON. Mask-consistency + negative-control validation in
    # tools/validate_tpu.py (logs/hw_validate_r3b.log).
    # port: false runs the head-major CUDA kernels of Queue 2 rows 5-8
    # (ops/attention_head_major_cuda.py) behind the same layout copies.
    attn_natural_layout: bool = True
    # Fused dual-stream tails: in two-stream sublayers (ViLBERT/LXMERT-style,
    # no single_ln) run ONE dropout+residual+LayerNorm chain over the
    # concatenated [text ‖ vision] sequence instead of two short per-stream
    # chains, applying each stream's LN affine per segment (LayerNorm
    # statistics are per-token, so the outputs are bit-identical — see
    # tests/test_fused_dual_stream.py). Parameter-shared sublayers (LXMERT
    # cross-attention) additionally compute QKV and the output projection
    # over the concatenated sequence: one matmul each instead of two.
    # Motivation was the round-4 lxmert trace: 15.6 ms/step of elementwise
    # loop fusions vs the fused single-stream path's 9.4 — the delta is
    # the duplicated short chains. MEASURED AND REFUTED on v5e (round 5,
    # b256 VQA step, logs/bench_*_r5a.log): lxmert 87.6 ms fused vs 82.9
    # unfused (-5.7%), vilbert 89.7 vs 85.8 (-4.5%, no shared sublayers —
    # the chain fusion alone loses). The fused trace
    # (logs/trace_lxmert_r5a_analysis.log) shows loop fusions at 17.9
    # ms/step, HIGHER than unfused: the [B, Lt+Lv, H] concats materialise
    # new buffers and break XLA's matmul-epilogue fusion of the per-stream
    # chains, costing more HBM traffic than the merged chain saves — the
    # same mechanism that sank the fused_residual kernel and the merged
    # QKV weight in rounds 1-2. Default OFF; kept opt-in (bit-equality
    # tested both ways) for wider-model shapes where the trade may flip.
    # Requires hidden_size == v_hidden_size and equal hidden dropout
    # rates; falls back per-stream otherwise.
    fuse_dual_stream: bool = False
    # Sub-flag of fuse_dual_stream: in parameter-shared sublayers also run
    # the Q/K/V input projections over the concatenated sequence (one
    # matmul instead of two). Separated out because the concat+slice
    # copies around the bigger matmul can cost more than the launch saves
    # (lxmert, which adds this piece, lost 1.2% more than vilbert).
    fuse_dual_qkv: bool = True

    _KNOWN = None  # populated below

    # ------------------------------------------------------------------ I/O
    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "VoltaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in obj.items() if k in known}
        cfg = cls(**kwargs)
        # Tolerate (and preserve) unknown keys like the reference does
        # (reference: volta/config.py:156-162 writes straight into __dict__).
        for k, v in obj.items():
            if k not in known:
                setattr(cfg, k, v)
        for name in (
            "sublayer2attn_hidden_size",
            "sublayer2num_attention_heads",
            "sublayer2intermediate_size",
            "sublayer2v_attn_hidden_size",
            "sublayer2v_num_attention_heads",
            "sublayer2v_intermediate_size",
            "bert_layer2attn_sublayer",
            "bert_layer2ff_sublayer",
            "visual_target_weights",
        ):
            setattr(cfg, name, _intkeys(getattr(cfg, name)))
        return cfg

    @classmethod
    def from_json_file(cls, path: str) -> "VoltaConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            out[f.name] = getattr(self, f.name)
        # include dynamically attached keys
        for k, v in self.__dict__.items():
            if k not in out:
                out[k] = v
        return out

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    # ------------------------------------------------------- derived plans
    @property
    def depth(self) -> int:
        attn = set(self.tt_attn_sublayers) | set(self.tv_attn_sublayers) | \
            set(self.vt_attn_sublayers) | set(self.vv_attn_sublayers)
        ff = set(self.t_ff_sublayers) | set(self.v_ff_sublayers)
        return len(attn) + len(ff)

    def sublayer_plan(self) -> List["SublayerSpec"]:
        """Static per-sublayer plan consumed by the encoder at build time.

        Validates the same invariants the reference asserts at runtime
        (reference: volta/encoders.py:842-843 contiguity,
        volta/encoders.py:172-201 divisibility / cross-modal equality).
        """
        attn = set(self.tt_attn_sublayers) | set(self.tv_attn_sublayers) | \
            set(self.vt_attn_sublayers) | set(self.vv_attn_sublayers)
        ff = set(self.t_ff_sublayers) | set(self.v_ff_sublayers)
        if attn & ff:
            raise ValueError("Overlapping attn-ff sublayer numbers: %s" % (attn & ff))
        all_ids = attn | ff
        depth = len(all_ids)
        if not all_ids or min(all_ids) != 0 or max(all_ids) != depth - 1:
            raise ValueError("Non contiguous sublayer numbers")

        plan = []
        for n in range(depth):
            kind = "attn" if n in attn else "ff"
            spec = SublayerSpec(
                index=n,
                kind=kind,
                has_tt=n in self.tt_attn_sublayers,
                has_tv=n in self.tv_attn_sublayers,
                has_vt=n in self.vt_attn_sublayers,
                has_vv=n in self.vv_attn_sublayers,
                has_t_ff=n in self.t_ff_sublayers,
                has_v_ff=n in self.v_ff_sublayers,
                shared=n in self.shared_sublayers,
                single_ln=n in self.single_ln_sublayers,
                attn_hidden_size=int(
                    self.sublayer2attn_hidden_size.get(str(n), self.hidden_size)),
                num_heads=int(
                    self.sublayer2num_attention_heads.get(str(n), self.num_attention_heads)),
                intermediate_size=int(
                    self.sublayer2intermediate_size.get(str(n), self.intermediate_size)),
                v_attn_hidden_size=int(
                    self.sublayer2v_attn_hidden_size.get(str(n), self.v_hidden_size)),
                v_num_heads=int(
                    self.sublayer2v_num_attention_heads.get(str(n), self.v_num_attention_heads)),
                v_intermediate_size=int(
                    self.sublayer2v_intermediate_size.get(str(n), self.v_intermediate_size)),
            )
            spec.validate(self)
            plan.append(spec)
        return plan


@dataclasses.dataclass
class SublayerSpec:
    """Static description of one sublayer of the gated encoder."""

    index: int
    kind: str  # "attn" | "ff"
    has_tt: bool = False
    has_tv: bool = False
    has_vt: bool = False
    has_vv: bool = False
    has_t_ff: bool = False
    has_v_ff: bool = False
    shared: bool = False
    single_ln: bool = False
    attn_hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    v_attn_hidden_size: int = 768
    v_num_heads: int = 12
    v_intermediate_size: int = 3072

    @property
    def has_text(self) -> bool:
        if self.kind == "attn":
            return self.has_tt or self.has_tv
        return self.has_t_ff

    @property
    def has_vision(self) -> bool:
        if self.kind == "attn":
            return self.has_vv or self.has_vt
        return self.has_v_ff

    @property
    def share_params(self) -> bool:
        return self.shared and self.has_text and self.has_vision

    def validate(self, cfg: VoltaConfig) -> None:
        if self.kind == "attn":
            if self.attn_hidden_size % self.num_heads != 0:
                raise ValueError(
                    f"sublayer {self.index}: text attn hidden size "
                    f"{self.attn_hidden_size} not divisible by {self.num_heads}")
            if self.v_attn_hidden_size % self.v_num_heads != 0:
                raise ValueError(
                    f"sublayer {self.index}: vision attn hidden size "
                    f"{self.v_attn_hidden_size} not divisible by {self.v_num_heads}")
            if self.has_tv or self.has_vt:
                if self.attn_hidden_size != self.v_attn_hidden_size or \
                        self.num_heads != self.v_num_heads:
                    raise ValueError(
                        f"sublayer {self.index}: cross-modal attention requires "
                        "equal hidden sizes and head counts")
            if self.share_params and self.attn_hidden_size != self.v_attn_hidden_size:
                raise ValueError(
                    f"sublayer {self.index}: shared attention requires equal sizes")
        else:
            if self.share_params:
                if cfg.hidden_size != cfg.v_hidden_size or \
                        self.intermediate_size != self.v_intermediate_size:
                    raise ValueError(
                        f"sublayer {self.index}: shared FF requires equal sizes")
        if self.single_ln and not (self.has_text and self.has_vision and self.shared):
            raise ValueError(
                f"sublayer {self.index}: single_ln requires text+vision+shared")

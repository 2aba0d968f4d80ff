"""Config → model builder for the whole architecture zoo (port of
``repro/models/model.py``).

One uniform block grammar covers all ten architectures:

  layer i = mixer(i) + ffn(i), where
    mixer(i) ∈ {attention (GQA/MQA/MHA + RoPE), mamba, rwkv6-tmix}
    ffn(i)   ∈ {dense MLP (swiglu/geglu/gelu), MoE, rwkv6-cmix}

Layers are grouped into *superblocks* of period
``p = lcm(attn_period, moe_period)`` whose kind pattern repeats. The
reference stacks the repeated superblocks on a leading axis and scans
them; here they are a ``ModuleList`` looped in Python, so a parameter's
name is the reference's dict path with the superblock's index after
``blocks`` (``blocks.<i>.s0.attn.wq``). A few leading layers can be
non-repeating (deepseek's dense layer 0): ``head.<i>``.

Whisper (enc-dec) adds a bidirectional encoder stack and cross-attention
in each decoder layer; phi-3-vision prepends projected patch embeddings
to the token embedding sequence.

Training differentiates :func:`loss_fn` with ``torch.autograd``; with
``cfg.remat`` each superblock (and each encoder layer) runs under
``torch.utils.checkpoint``, where the reference wraps its scanned body
in ``jax.checkpoint``. With ``layers.OPT["remat_dots"]`` the checkpoint
saves the products' outputs (``aten.mm``/``bmm``) and recomputes the
rest, the counterpart of ``jax.checkpoint_policies.checkpoint_dots``.

On a ``DeviceMesh`` the parameters are DTensors placed by
``models.sharding`` and the batch is sharded over the data axes; the
forward runs under ``layers.activation_mesh_scope`` of that mesh. The
head and the cross entropy are vocab-parallel (:func:`logits_of`,
:func:`token_nll`): the logits stay sharded over ``model``.

Entry points build on the card unless asked for another device:
``init_params(cfg, seed, device="cpu")`` on the CPU, ``device="meta"``
for shapes only (``abstract_params``, ``param_count``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import mamba as M
from . import moe as MOE
from . import rwkv6 as R


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"     # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 1e4
    use_rope: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma: scale embeddings by sqrt(d)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    dense_d_ff: int = 0          # d_ff of non-MoE layers in MoE/hybrid models
    first_dense: int = 0         # deepseek: first k layers use dense FFN
    moe_aux_coef: float = 0.01
    # --- hybrid / ssm mixers ---
    mixer: str = "attn"          # attn | mamba_hybrid | rwkv
    attn_period: int = 1
    attn_offset: int = 0
    ssm_expand: int = 2
    ssm_state: int = 16
    ssm_conv: int = 4
    rwkv_head_size: int = 64
    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper: conv-frontend output frames
    # --- vlm stub frontend ---
    vision_patches: int = 0
    vision_d: int = 1024
    # --- numerics / structure ---
    dtype: str = "bfloat16"
    remat: bool = True           # checkpoint each superblock in training
    logits_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def attn_dims(self) -> L.AttnDims:
        return L.AttnDims(self.n_heads, self.n_kv_heads, self.hd)

    @property
    def mamba_dims(self) -> M.MambaDims:
        return M.MambaDims(d_inner=self.ssm_expand * self.d_model,
                           d_state=self.ssm_state, d_conv=self.ssm_conv,
                           dt_rank=max(1, (self.d_model + 15) // 16))

    @property
    def rwkv_dims(self) -> R.RWKVDims:
        return R.RWKVDims(n_heads=self.d_model // self.rwkv_head_size,
                          head_size=self.rwkv_head_size, d_ff=self.d_ff)

    @property
    def moe_dims(self) -> MOE.MoEDims:
        return MOE.MoEDims(n_experts=self.n_experts, top_k=self.top_k,
                           d_expert=self.d_ff,
                           n_shared=self.n_shared_experts,
                           mlp_kind=self.mlp_kind)

    @property
    def tdtype(self) -> torch.dtype:
        """The torch counterpart of the reference's ``jdtype``."""
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    # ---- block grammar ----
    def layer_kinds(self, i: int) -> Tuple[str, str]:
        if self.mixer == "rwkv":
            return "rwkv", "cmix"
        if self.mixer == "mamba_hybrid":
            mix = "attn" if i % self.attn_period == self.attn_offset \
                else "mamba"
        else:
            mix = "attn"
        if self.n_experts and i >= self.first_dense \
                and (i % self.moe_period) == self.moe_offset:
            ffn = "moe"
        else:
            ffn = "dense"
        return mix, ffn

    @property
    def super_period(self) -> int:
        if self.mixer == "rwkv" or not self.n_experts:
            p = self.attn_period if self.mixer == "mamba_hybrid" else 1
        else:
            p = math.lcm(self.attn_period
                         if self.mixer == "mamba_hybrid" else 1,
                         self.moe_period)
        return p

    @property
    def n_head_layers(self) -> int:
        # leading non-repeating layers (deepseek's dense first layer(s))
        return self.first_dense

    @property
    def n_super(self) -> int:
        body = self.n_layers - self.n_head_layers
        assert body % self.super_period == 0, \
            (self.name, body, self.super_period)
        return body // self.super_period


# ===================================================================== #
# parameter construction
# ===================================================================== #
class Sublayer(nn.Module):
    """One (mixer + ffn) layer: ``norm1``, ``attn`` | ``mamba`` |
    ``tmix``, [``norm_x``, ``cross``], ``norm2``, ``mlp`` | ``moe`` |
    ``cmix``."""

    def __init__(self, cfg: ModelConfig, mix: str, ffn: str, cross: bool,
                 device):
        super().__init__()
        dt, d = cfg.tdtype, cfg.d_model
        self.mix, self.ffn = mix, ffn
        self.norm1 = L.Norm(d, cfg.norm, device)
        self.norm2 = L.Norm(d, cfg.norm, device)
        if mix == "attn":
            self.attn = L.Attention(d, cfg.attn_dims, dt, device)
        elif mix == "mamba":
            self.mamba = M.Mamba(d, cfg.mamba_dims, dt, device)
        else:
            self.tmix = R.RWKVTmix(d, cfg.rwkv_dims, dt, device)
        if cross:
            self.norm_x = L.Norm(d, cfg.norm, device)
            self.cross = L.Attention(d, cfg.attn_dims, dt, device)
        if ffn == "moe":
            self.moe = MOE.MoE(d, cfg.moe_dims, dt, device)
        elif ffn == "cmix":
            self.cmix = R.RWKVCmix(d, cfg.rwkv_dims, dt, device)
        else:
            self.mlp = L.MLP(d, cfg.dense_d_ff or cfg.d_ff, cfg.mlp_kind, dt,
                             device)


class Model(L.Leaves):
    """The whole parameter tree of one configuration; ``forward`` runs
    :func:`forward`."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        dev = L.model_device(device)
        super().__init__(dev)
        self.cfg = cfg
        dt, d = cfg.tdtype, cfg.d_model
        self.leaf("tok_embed", (cfg.vocab, d), dt, L.normal(0.02))
        self.final_norm = L.Norm(d, cfg.norm, dev)
        if not cfg.tie_embeddings:
            self.leaf("lm_head", (d, cfg.vocab), dt, L.normal())
        cross = cfg.family == "encdec"
        if cfg.n_head_layers:
            self.head = nn.ModuleDict({
                str(i): Sublayer(cfg, *cfg.layer_kinds(i), cross, dev)
                for i in range(cfg.n_head_layers)})
        kinds = _super_kinds(cfg)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"s{j}": Sublayer(cfg, mix, ffn, cross, dev)
                           for j, (mix, ffn) in enumerate(kinds)})
            for _ in range(cfg.n_super))
        if cfg.family == "encdec":
            self.encoder = nn.ModuleList(
                Sublayer(cfg, "attn", "dense", False, dev)
                for _ in range(cfg.encoder_layers))
            self.enc_final_norm = L.Norm(d, cfg.norm, dev)
            self.leaf("dec_pos_embed", (32768, d), dt, L.normal(0.02))
        if cfg.family == "vlm":
            self.leaf("patch_proj", (cfg.vision_d, d), dt, L.normal())

    def forward(self, batch, *, return_aux=True):
        return forward(self.cfg, self, batch, return_aux=return_aux)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Model:
    """The model of ``cfg`` on ``device``, drawn from a ``torch.Generator``
    seeded with ``seed`` with the reference's distributions (normal ×
    ``fan_in^-0.5``, 0.02 for embeddings, ones and zeros for norms)."""
    model = Model(cfg, device)
    gen = torch.Generator(device=model._device).manual_seed(seed)
    L.reset_parameters(model, gen)
    return model


def abstract_params(cfg: ModelConfig) -> Model:
    """The model on the ``meta`` device: shapes, no allocation."""
    return Model(cfg, "meta")


def param_count(cfg: ModelConfig) -> int:
    return sum(p.numel() for p in abstract_params(cfg).parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top-k + shared experts only)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert = sum(p.numel() for name, p in
                 abstract_params(cfg).named_parameters()
                 if "moe" in name.split(".")
                 and name.split(".")[-1] in ("wi", "wg", "wo"))
    return int(total - expert * (1 - cfg.top_k / cfg.n_experts))


def _tree_leaf(tree, name: str):
    """The reference tree's leaf for one of the port's parameter names:
    ``blocks.<i>.…`` and ``encoder.<i>.…`` index the stacked leaf."""
    parts = name.split(".")
    idx = None
    if parts[0] in ("blocks", "encoder"):
        idx = int(parts.pop(1))
    node = tree
    for part in parts:
        node = node[part]
    return node if idx is None else node[idx]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def to_torch(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 (``ml_dtypes``) goes through
    float32 exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree, device="cuda") -> Model:
    """The port's model holding the reference's parameter tree (leaves as
    numpy, repeated superblocks stacked on a leading axis)."""
    model = Model(cfg, device)
    n = 0
    for name, p in model.named_parameters():
        leaf = to_torch(_tree_leaf(tree, name))
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {tuple(leaf.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(leaf)
        n += p.numel()
    if n != sum(int(np.prod(np.shape(a))) for a in _leaves(tree)):
        raise ValueError("the tree holds leaves the model has not")
    return model


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """The reference's parameter tree of ``model``: leaves as numpy
    (bfloat16 as float32), repeated superblocks and encoder layers
    stacked on a leading axis."""
    return stack_named(
        ((name, host_numpy(p)) for name, p in model.named_parameters()),
        np.stack)


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bfloat16 (which numpy lacks) as
    float32."""
    return t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16
                         else t.dtype, copy=True).numpy()


def stack_named(named, stack=torch.stack) -> Dict[str, Any]:
    """The reference's tree of ``(name, leaf)`` pairs named as the port's
    parameters: ``blocks.<i>.…`` and ``encoder.<i>.…`` stacked on a
    leading axis in ``i``'s order by ``stack`` (``torch.stack`` keeps
    each leaf's dtype and device), the rest nested by name."""
    tree: Dict[str, Any] = {}
    stacked: Dict[Tuple[str, ...], Dict[int, Any]] = {}
    for name, leaf in named:
        parts = name.split(".")
        if parts[0] in ("blocks", "encoder"):
            stacked.setdefault((parts[0], *parts[2:]), {})[
                int(parts[1])] = leaf
        else:
            _put(tree, parts, leaf)
    for parts, by_index in stacked.items():
        _put(tree, parts, stack([by_index[i] for i in sorted(by_index)]))
    return tree


def unstack_named(tree, names) -> Dict[str, Any]:
    """The inverse of :func:`stack_named`: each name's leaf of the
    reference's tree (a stacked leaf indexed)."""
    return {name: _tree_leaf(tree, name) for name in names}


def _put(tree, parts, value):
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


# ===================================================================== #
# forward
# ===================================================================== #
def _run_sublayer(cfg: ModelConfig, p: Sublayer, x, *, positions,
                  cache=None, cache_pos=None, state=None, enc_kv=None,
                  aux=None, causal=True):
    """One (mixer + ffn) layer with pre-norm residuals.

    Returns (x, new_cache_or_state, aux).
    """
    mix, ffn = p.mix, p.ffn
    h = L.apply_norm(p.norm1, x)
    if mix == "attn":
        out, new_cs = L.attention(
            p.attn, h, cfg.attn_dims, positions=positions,
            cache=cache, cache_pos=cache_pos,
            rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
            causal=causal, chunked=(None if cache is not None else False))
    elif mix == "mamba":
        out, new_cs = M.mamba_block(p.mamba, h, cfg.mamba_dims, state=state)
    else:  # rwkv tmix
        st = None if state is None else state["tmix"]
        out, new_cs = R.rwkv_tmix(p.tmix, h, cfg.rwkv_dims, state=st)
    x = x + out.to(x.dtype)

    if enc_kv is not None:  # cross-attention (decoder)
        hx = L.apply_norm(p.norm_x, x)
        out, _ = L.attention(p.cross, hx, cfg.attn_dims,
                             positions=positions, kv_override=enc_kv,
                             causal=False, use_rope=False)
        x = x + out.to(x.dtype)

    h2 = L.apply_norm(p.norm2, x)
    new_cmix_state = None
    if ffn == "moe":
        out, a = MOE.moe_ffn(p.moe, h2, cfg.moe_dims)
        aux = a if aux is None else aux + a
    elif ffn == "cmix":
        cm_state = None if state is None else state.get("cmix_shift")
        out, new_cmix_state = R.rwkv_cmix(p.cmix, h2, state=cm_state)
    else:
        out = L.mlp(p.mlp, h2, cfg.mlp_kind)
    x = x + out.to(x.dtype)
    if ffn == "cmix" and state is not None:
        new_cs = {"tmix": new_cs, "cmix_shift": new_cmix_state}
    return x, new_cs, aux


def _super_kinds(cfg: ModelConfig):
    p0 = cfg.n_head_layers
    return [cfg.layer_kinds(p0 + j) for j in range(cfg.super_period)]


def _sinusoid_pos(seq, d, device):
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return torch.as_tensor(np.concatenate([np.sin(ang), np.cos(ang)],
                                          axis=-1),
                           dtype=torch.float32, device=device)


def encode(cfg: ModelConfig, model: Model, frames):
    """Whisper encoder over (precomputed, stubbed) frame embeddings."""
    dt = cfg.tdtype
    x = frames.to(dt) + _sinusoid_pos(frames.shape[1], cfg.d_model,
                                      frames.device).to(dt)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def body(p, h):
        return _run_sublayer(cfg, p, h, positions=positions,
                             causal=False)[0]

    for p in model.encoder:
        x = _remat(cfg, body, p, x)
    return L.apply_norm(model.enc_final_norm, x)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    when ``cfg.remat`` and autograd is recording (the reference wraps
    each scanned body in ``jax.checkpoint``; ``OPT["remat_dots"]``
    keeps the products' outputs)."""
    if cfg.remat and torch.is_grad_enabled():
        if L.OPT["remat_dots"]:
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_dots_context)
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def cross_kv(cfg: ModelConfig, p: L.Attention, h_enc, dtype=None):
    """A decoder layer's cross K/V (B, Hk, T, hd) from the encoder's
    output. On a ``DeviceMesh`` each model rank projects its own KV heads
    when they divide the axis; otherwise the projections are
    column-parallel and gathered (``layers.col_gathered``)."""
    hd = cfg.hd
    if L.is_dtensor(h_enc) and cfg.n_kv_heads % L._model_axis():
        k, v = (L.heads_of(L.col_gathered(h_enc, w), hd)
                for w in (p.wk, p.wv))
    else:
        xs = L.stream_spec(h_enc)
        wk, wv = (L.fsdp_use(w, None, "model") for w in (p.wk, p.wv))
        cols = L.local_spec(wk, (None, "model"))
        spec = xs[:1] + [cols[1], None, None]
        k, v = L.shard_local(
            lambda h, wk, wv: (L._heads(L.mm(h, wk), hd),
                               L._heads(L.mm(h, wv), hd)),
            (h_enc, wk, wv), (xs, cols, cols), (spec, spec))
    return (k, v) if dtype is None else (k.to(dtype), v.to(dtype))


def embed(cfg: ModelConfig, model: Model, tokens, patches=None):
    """Token embeddings (gemma's √d scale), with phi-3-vision's projected
    patches prepended when given."""
    x = L.embed_lookup(model.tok_embed, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if patches is not None:
        x = torch.cat([L.col_gathered(patches.to(cfg.tdtype),
                                      model.patch_proj), x], dim=1)
    return x


def dec_positions(model: Model, positions):
    """Whisper's learned decoder position embeddings at ``positions``,
    whole over ``model`` (the table is sharded on d), so that the stream
    they join stays replicated there."""
    return L.shard_hint(model.dec_pos_embed[positions], None, None)


def logits_of(cfg: ModelConfig, model: Model, x):
    """Final norm and the (tied) head, float32 logits, softcapped. On a
    ``DeviceMesh`` the head is column-parallel over the vocabulary (the
    tied head is ``tok_embed``'s rows, vocab-sharded as the lookup takes
    them): each model rank makes the logits of its own vocabulary range,
    softcapped there, and they stay sharded over ``model`` (``Shard(-1)``,
    the reference's layout); a vocabulary the axis does not divide is
    whole on every rank."""
    x = L.apply_norm(model.final_norm, x)
    tied = cfg.tie_embeddings
    w = model.tok_embed if tied else model.lm_head
    cap = cfg.logits_softcap

    def head(x, w):
        logits = (x @ (w.T if tied else w).to(x.dtype)).float()
        return torch.tanh(logits / cap) * cap if cap else logits
    xs = L.stream_spec(x)
    ws = L.local_spec(w, ("model", None) if tied else (None, "model"))
    return L.shard_local(head, (x, w), (xs, ws),
                         xs[:-1] + [ws[0] if tied else ws[1]])


def forward(cfg: ModelConfig, model: Model, batch, *, return_aux=True):
    """Training/prefill forward → logits (B, S, V).

    batch: dict with "tokens" (B, S) plus per-family extras:
      encdec: "frames" (B, T_enc, d_model); vlm: "patches" (B, P, vision_d).
    """
    x = embed(cfg, model, batch["tokens"],
              batch["patches"] if cfg.family == "vlm" else None)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(cfg, model, batch["frames"])
        x = x + dec_positions(model, positions)

    def run_block(subs, h, aux):
        for p in subs:
            ekv = None if enc_out is None else cross_kv(cfg, p.cross,
                                                        enc_out)
            h, _, aux = _run_sublayer(cfg, p, h, positions=positions,
                                      enc_kv=ekv, aux=aux)
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_head_layers):
        x, aux = run_block([model.head[str(i)]], x, aux)
    for blk in model.blocks:            # the reference's scanned body
        x, aux = _remat(cfg, run_block,
                        [blk[f"s{j}"] for j in range(len(blk))], x, aux)
    logits = logits_of(cfg, model, x)
    if return_aux:
        return logits, aux
    return logits


def loss_fn(cfg: ModelConfig, model: Model, batch):
    """Mean next-token cross entropy; labels −100 are masked. Returns
    ``(loss, {"ce", "aux"})``; ``torch.autograd`` differentiates it
    through every family (the reference's ``jax.value_and_grad``)."""
    logits, aux = forward(cfg, model, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":  # logits cover [patches; text] — text tail only
        logits = logits[:, -labels.shape[1]:]
    nll = token_nll(logits, labels)
    ce = L.shard_hint(nll.sum() / torch.clamp((labels >= 0).sum(), min=1))
    return ce + cfg.moe_aux_coef * aux, {"ce": ce, "aux": aux}


def token_nll(logits, labels):
    """Each token's negative log-likelihood of its label (0 where the
    label is masked), batch-sharded as ``labels``. With the logits
    vocab-sharded over ``model`` the cross entropy is vocab-parallel, as
    the reference's iota-mask form keeps it: each model rank takes the
    logsumexp of its own vocabulary range and its label's logit where
    the label falls in that range (a partial sum); the ranks'
    logsumexps, one a token and rank, are combined over ``model`` and
    the picks all-reduced, so no (B, S, V) tensor is gathered. Otherwise
    per data shard, the logits whole over ``model``."""
    spec = L.local_spec(logits, (L.DP, None, "model"))
    bs = spec[:2]
    if not L.is_dtensor(logits) or spec[-1] is None:
        return L.shard_local(_token_nll, (logits, labels), (bs + [None], bs),
                             bs)
    lo = L.shard_start(logits.shape[-1], logits)

    def parts(logits, labels):
        local = torch.where(labels >= 0, labels, 0).long() - lo
        hit = (local >= 0) & (local < logits.shape[-1])
        ll = torch.take_along_dim(
            logits, torch.where(hit, local, 0)[..., None], dim=-1)[..., 0]
        return torch.logsumexp(logits, dim=-1, keepdim=True), \
            torch.where(hit, ll, 0)
    lse, ll = L.shard_local(parts, (logits, labels), (spec, bs),
                            (bs + ["model"], L.Summed(bs)))

    def combine(lse, ll, labels):
        return (torch.logsumexp(lse, dim=-1) - ll) * (labels >= 0)
    return L.shard_local(combine, (lse, ll, labels), (bs + [None], bs, bs),
                         bs)


def _token_nll(logits, labels):
    """Each token's negative log-likelihood of its label (0 where the
    label is masked)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    return (lse - ll) * mask

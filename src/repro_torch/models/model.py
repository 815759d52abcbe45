"""Config -> Model: init / param_specs / forward / loss
(``repro/models/model.py``).

Every family of the JAX package: dense (qwen2, minitron, phi3, minicpm),
moe (granite-moe, dbrx: attention and a mixture of experts a layer,
``layers.moe_apply``), ssm (mamba2: one SSD block a layer,
``layers.mamba2_apply``), hybrid (zamba2: Mamba-2 layers and one shared
attention+MLP block after every ``attn_every``-th), encdec (whisper: a
non-causal encoder over the batch's ``frames``, decoder blocks with
cross-attention, sinusoidal positions) and vlm (qwen2-vl: M-RoPE, the
batch's ``vision_embeds`` before the text).  The serving half
(:meth:`Model.init_cache`, :meth:`Model.decode_step`,
:meth:`Model.prefill`, :meth:`Model.encode_cross_cache`) keeps JAX's
cache tree and layout, a lane per slot of axis 1.  Params are a nested
dict in the JAX layout:
per-layer weights stacked on a leading L axis, ``x @ W`` weights, the
embedding reused as the LM head under tied embeddings.  The leaf paths,
shapes and flatten order therefore equal the JAX tree's, which the wire's
per-leaf layout depends on.  ``init`` follows JAX's key tree, so
``init(random.key(s))`` is ``Model.init(jax.random.key(s))`` bit for bit.

On a mesh with a ``model`` axis of M ranks (``tp``, a
:class:`~repro_torch.models.layers.ModelAxis`) each rank holds the shards
that :meth:`Model.param_specs` names, in every family, and computes the
logical function: an attention whose heads split whole and an MLP run
Megatron-style (column-parallel q/k/v with biases and gate/up, row-parallel
o and down followed by an all-reduce); a vocab-sharded embedding and LM
head (tied or not) run vocab-parallel, with a vocab-parallel
cross-entropy; every other sharded leaf -- an attention whose heads do not
split whole, the SSD block, the experts -- is gathered on use, one layer at
a time, and its compute runs replicated over the axis
(``layers.gather_tree``).  Replicated leaves (granite's attention, an
embedding whose vocab 16 does not divide) run the plain ops, with no
collective.  M must split every sharded dim
(:meth:`Model.model_axis_refusal`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random, resolve_device
from repro_torch import tree as T
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

PyTree = Any
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over positions with label >= 0.  logits (B,S,V), labels (B,S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    per_tok = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return per_tok.sum() / denom, denom


#: the families the port builds: all of the JAX package's
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
#: key-tree parts drawn once, not per layer (the hybrid's shared block)
UNSTACKED = ("shared_attn", "shared_mlp")
#: dt_bias's uniform range (``mamba2_init``): log(1e-3) to log(1e-1)
DT_RANGE = (math.log(1e-3), math.log(1e-1))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r} (known: "
                             f"{', '.join(FAMILIES)})")
        if cfg.param_dtype != "float32":
            raise NotImplementedError("the port keeps f32 params")

    # ------------------------------------------------------------------ init

    def _attn(self, make, part: str, lead: Tuple[int, ...]
              ) -> Dict[str, Any]:
        """``attention_init``'s leaves under the key-tree ``part`` (wq, wk,
        wv, wo; zero biases under ``qkv_bias``), each of shape ``lead``
        plus its own (``lead`` = (L,) for stacked layers)."""
        cfg = self.cfg
        d, hd, nh, nkv = cfg.d_model, cfg.hd(), cfg.n_heads, cfg.n_kv_heads
        attn = {
            "wq": make((part, 0), lead + (d, nh * hd), 1.0 / math.sqrt(d)),
            "wk": make((part, 1), lead + (d, nkv * hd), 1.0 / math.sqrt(d)),
            "wv": make((part, 2), lead + (d, nkv * hd), 1.0 / math.sqrt(d)),
            "wo": make((part, 3), lead + (nh * hd, d),
                       1.0 / math.sqrt(nh * hd)),
        }
        if cfg.qkv_bias:
            attn.update({"bq": make(None, lead + (nh * hd,), 0.0),
                         "bk": make(None, lead + (nkv * hd,), 0.0),
                         "bv": make(None, lead + (nkv * hd,), 0.0)})
        return attn

    def _mlp(self, make, part: str, lead: Tuple[int, ...]
             ) -> Dict[str, Any]:
        """``mlp_init``'s leaves (wg, wu, wd) under the key-tree ``part``."""
        d, ff = self.cfg.d_model, self.cfg.d_ff
        return {"wg": make((part, 0), lead + (d, ff), 1.0 / math.sqrt(d)),
                "wu": make((part, 1), lead + (d, ff), 1.0 / math.sqrt(d)),
                "wd": make((part, 2), lead + (ff, d), 1.0 / math.sqrt(ff))}

    def _block(self, make) -> Dict[str, Any]:
        """One family's stacked per-layer leaves (JAX's ``_block_inits``
        under ``vmap``), each from ``make`` as in :meth:`_build`."""
        cfg = self.cfg
        d, ff, Lr = cfg.d_model, cfg.d_ff, cfg.n_layers
        if cfg.family in ("ssm", "hybrid"):
            di, st, nh = cfg.d_inner(), cfg.ssm_state, cfg.ssm_heads()
            conv_ch = di + 2 * st
            return {
                "mamba": {
                    "wz": make(("mamba", 0), (Lr, d, di), 1.0 / math.sqrt(d)),
                    "wx": make(("mamba", 1), (Lr, d, di), 1.0 / math.sqrt(d)),
                    "wB": make(("mamba", 2), (Lr, d, st), 1.0 / math.sqrt(d)),
                    "wC": make(("mamba", 3), (Lr, d, st), 1.0 / math.sqrt(d)),
                    "wdt": make(("mamba", 4), (Lr, d, nh), 0.02),
                    "dt_bias": make(("mamba", 5), (Lr, nh), "dt_bias"),
                    "A_log": make(None, (Lr, nh), "A_log"),
                    "D": make(None, (Lr, nh), None),
                    "conv_w": make(("mamba", 6), (Lr, cfg.ssm_conv, conv_ch),
                                   0.5 / math.sqrt(cfg.ssm_conv)),
                    "conv_b": make(None, (Lr, conv_ch), 0.0),
                    "norm_w": make(None, (Lr, di), None),
                    "wo": make(("mamba", 7), (Lr, di, d),
                               1.0 / math.sqrt(di)),
                },
                "ln": make(None, (Lr, d), None),
            }
        block: Dict[str, Any] = {"attn": self._attn(make, "attn", (Lr,))}
        if cfg.family == "moe":
            E = cfg.n_experts
            # _init's default scale is 1 / sqrt(shape[0]): E for wg and wu
            block["moe"] = {
                "router": make(("moe", 0), (Lr, d, E), 0.02),
                "wg": make(("moe", 1), (Lr, E, d, ff), 1.0 / math.sqrt(E)),
                "wu": make(("moe", 2), (Lr, E, d, ff), 1.0 / math.sqrt(E)),
                "wd": make(("moe", 3), (Lr, E, ff, d), 1.0 / math.sqrt(ff)),
            }
        else:
            block["mlp"] = self._mlp(make, "mlp", (Lr,))
        if cfg.family == "encdec":
            block["xattn"] = self._attn(make, "xattn", (Lr,))
            block["ln3"] = make(None, (Lr, d), None)
        block["ln1"] = make(None, (Lr, d), None)
        block["ln2"] = make(None, (Lr, d), None)
        return block

    def _build(self, make: Callable[[Optional[Tuple[str, int]],
                                     Tuple[int, ...], Any], torch.Tensor]
               ) -> PyTree:
        """The params tree, each leaf from ``make(site, shape, init)``: for
        a float ``init``, a normal draw times ``init`` under the key of
        ``site`` in JAX's key tree (:meth:`init`); zeros for 0.0 and ones
        for None; ``"dt_bias"`` and ``"A_log"`` are mamba2's two computed
        leaves.  Init distributions are the JAX package's (biases zero,
        norms one)."""
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab
        params: Dict[str, Any] = {
            "embed": make(("embed", 1), (V, d), 0.02),
            "layers": self._block(make),
            "final_norm": make(None, (d,), None),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = make(("embed", 2), (d, V),
                                     1.0 / math.sqrt(d))
        if cfg.family == "hybrid":
            params["shared_attn"] = {
                "attn": self._attn(make, "shared_attn", ()),
                "mlp": self._mlp(make, "shared_mlp", ()),
                "ln1": make(None, (d,), None),
                "ln2": make(None, (d,), None)}
        if cfg.family == "encdec":
            E = (cfg.encoder_layers,)
            params["encoder"] = {
                "attn": self._attn(make, "enc_attn", E),
                "mlp": self._mlp(make, "enc_mlp", E),
                "ln1": make(None, E + (d,), None),
                "ln2": make(None, E + (d,), None)}
            params["enc_norm"] = make(None, (d,), None)
        return params

    def init(self, key=None, device="cuda") -> PyTree:
        """f32 params on ``device`` from the threefry ``key`` (a
        ``repro_torch.random`` key; ``key(0)`` when None), drawn as
        ``repro.models.model.Model.init(jax.random.key(s))`` draws them,
        bit for bit: ``keys = split(key, 8)``; layer l's key is
        ``split(keys[0], L)[l]`` (:func:`_layer_keys`); the embedding draws
        under ``keys[1]`` (an untied head under ``keys[2]``); the hybrid's
        shared block under ``split(keys[3])`` (attention, MLP), the encdec
        encoder's layer e under ``split(split(keys[4], E)[e])`` (attention,
        MLP).  Each weight
        is ``normal(key, shape) * scale``, all of them drawn in one
        ``random.normal_many`` pass.  mamba2's ``dt_bias`` is
        ``log(expm1(exp(u)))`` of a uniform on [log 1e-3, log 1e-1) and its
        ``A_log`` is ``log(1..H)``, each op XLA CPU's f32 function
        (``random.xla_exp``, ``xla_expm1``, ``xla_log``)."""
        dev = resolve_device(device)
        cfg = self.cfg
        keys = random.split(random.key(0) if key is None else key, 8)
        layers = [_layer_keys(cfg.family, k)
                  for k in random.split(keys[0], cfg.n_layers)]
        sub = {part: [lk[part] for lk in layers] for part in layers[0]}
        if cfg.family == "hybrid":
            k1, k2 = random.split(keys[3])
            sub.update(shared_attn=[random.split(k1, 4)],
                       shared_mlp=[random.split(k2, 3)])
        if cfg.family == "encdec":
            enc = [_encoder_keys(ke) for ke in random.split(
                keys[4], cfg.encoder_layers)]
            sub.update({part: [ek[part] for ek in enc] for part in enc[0]})
        # every weight's draws in one pass (``random.normal_many``), in the
        # order _build makes the leaves: the embedding's key, or a stacked
        # leaf's key of each layer, its layers consecutive
        draws = []

        def plan(site, shape, init):
            if isinstance(init, float) and init != 0.0:
                part, i = site
                if part == "embed":
                    draws.append((keys[i], math.prod(shape)))
                elif part in UNSTACKED:
                    draws.append((sub[part][0][i], math.prod(shape)))
                else:
                    draws.extend((ks[i], math.prod(shape[1:]))
                                 for ks in sub[part])

        self._build(plan)
        z = random.normal_many([k for k, _ in draws], [n for _, n in draws],
                               dev)
        off = 0

        def make(site, shape, init):
            nonlocal off
            if init is None:
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if init == 0.0:
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            if init == "A_log":
                h = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                 device=dev)
                return random.xla_log(h).expand(shape).clone()
            if init == "dt_bias":
                part, i = site
                with random._serial(dev):
                    u = torch.stack([
                        random.uniform(ks[i], shape[-1], dev,
                                       minval=DT_RANGE[0],
                                       maxval=DT_RANGE[1])
                        for ks in sub[part]])
                    return random.xla_log(random.xla_expm1(
                        random.xla_exp(u)))
            n = math.prod(shape)
            leaf = z[off:off + n].reshape(shape).mul_(init).clone()
            off += n
            return leaf

        return self._build(make)

    def init_abstract(self) -> PyTree:
        """Params as ``meta`` tensors: shapes and dtypes, no storage."""
        return self._build(lambda site, shape, init: torch.empty(
            shape, dtype=torch.float32, device="meta"))

    def param_specs(self) -> PyTree:
        """Each leaf's spec over the mesh's ``model`` axis, a tuple of axis
        names per dim (JAX's PartitionSpecs, ``Model.param_specs``): the
        per-layer specs of the family's block lifted over the stacked L
        axis, the embedding by ``auto_spec`` on its vocab dim."""
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab
        attn = L.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
                                 cfg.qkv_bias, cfg.attn_shard_policy)
        lift = lambda tree: T.tree_map(  # noqa: E731
            lambda s: (None,) + s, tree, is_leaf=L.is_spec)
        if cfg.family in ("ssm", "hybrid"):
            block = {"mamba": L.mamba2_specs(
                d, d_inner=cfg.d_inner(), d_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads(), d_conv=cfg.ssm_conv),
                "ln": (None,)}
        else:
            block = {"attn": attn, "ln1": (None,), "ln2": (None,)}
            if cfg.family == "moe":
                block["moe"] = L.moe_specs(d, cfg.d_ff, cfg.n_experts)
            else:
                block["mlp"] = L.mlp_specs(d, cfg.d_ff)
            if cfg.family == "encdec":
                block.update(xattn=attn, ln3=(None,))
        specs: Dict[str, Any] = {
            "embed": L.auto_spec((V, d), prefer=(0,)),
            "layers": lift(block),
            "final_norm": (None,),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = L.auto_spec((d, V), prefer=(1,))
        shared = {"attn": attn, "mlp": L.mlp_specs(d, cfg.d_ff),
                  "ln1": (None,), "ln2": (None,)}
        if cfg.family == "hybrid":
            specs["shared_attn"] = shared
        if cfg.family == "encdec":
            specs["encoder"] = lift(shared)
            specs["enc_norm"] = (None,)
        return specs

    def model_axis_refusal(self, size: int) -> str:
        """Why the model cannot run on a ``model`` axis of ``size`` ranks
        ('' when it can): a leaf that ``param_specs`` shards on a dim that
        ``size`` does not divide (a model axis of 3, say).  Every family
        runs on any axis that splits its sharded dims, heads whole or not
        (the module docstring); JAX's driver cannot place such a state
        either."""
        for (path, leaf), spec in zip(
                T.flatten_with_path(self.init_abstract()),
                T.leaves(self.param_specs(), is_leaf=L.is_spec)):
            dim = L.spec_dim(spec)
            if dim is not None and leaf.shape[dim] % size:
                # JAX places the state with device_put, which raises here
                return (f"a 'model' axis of {size}: {'/'.join(path)} "
                        f"{tuple(leaf.shape)} does not split over {size} "
                        f"ranks: its dim {dim} of size {leaf.shape[dim]} "
                        f"is not divisible by {size}, as JAX's sharding "
                        "of the state requires")
        return ""

    def _specs(self) -> PyTree:
        """:meth:`param_specs` with the stacked trees' specs per layer (the
        lifted L axis dropped), as :func:`_per_layer` hands out leaves."""
        specs = self.param_specs()
        unlift = lambda tree: T.tree_map(  # noqa: E731
            lambda s: s[1:], tree, is_leaf=L.is_spec)
        return {k: unlift(v) if k in ("layers", "encoder") else v
                for k, v in specs.items()}

    def vocab_sharded(self, tp: Optional[L.ModelAxis]) -> bool:
        """Whether the LM head (the embedding, when tied) is vocab-sharded
        on ``tp``: then the logits are this rank's vocab shard and the loss
        is the vocab-parallel cross-entropy."""
        if tp is None:
            return False
        specs = self.param_specs()
        head = specs["embed"][::-1] if self.cfg.tie_embeddings \
            else specs["lm_head"]
        return L.spec_dim(head) is not None

    def _attend(self, p: Dict[str, torch.Tensor], specs: Dict[str, Any],
                x: torch.Tensor, tp: Optional[L.ModelAxis], *,
                kv_src: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
        """One attention on this rank's leaves ``p`` (self-attention, or
        cross-attention over ``kv_src``, projected by ``p``'s k and v with
        no bias and no rope): Megatron-style where ``layers.head_aligned``,
        else on the weights gathered on use, replicated over the axis."""
        cfg = self.cfg
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
        reduce = None
        if tp is not None and L.head_aligned(specs, nh, nkv, tp.size):
            nh, nkv, reduce = nh // tp.size, nkv // tp.size, tp
            x = L.to_model(x, tp)
            if kv_src is not None:
                kv_src = L.to_model(kv_src, tp)
        else:
            p = L.gather_tree(p, specs, tp)
        kv = None
        if kv_src is not None:
            B, Se, _ = kv_src.shape
            kv = tuple((kv_src @ p[w].to(x.dtype)).reshape(B, Se, nkv, hd)
                       for w in ("wk", "wv"))
        return L.from_model(L.attention(p, x, n_heads=nh, n_kv=nkv, hd=hd,
                                        kv=kv, **kw), reduce)

    @staticmethod
    def _ffn(p: Dict[str, torch.Tensor], specs: Dict[str, Any],
             x: torch.Tensor, tp: Optional[L.ModelAxis]) -> torch.Tensor:
        """SwiGLU on this rank's leaves: Megatron-style where
        ``layers.mlp_aligned``, else gathered on use (a no-op for
        replicated leaves)."""
        if tp is not None and L.mlp_aligned(specs):
            return L.from_model(L.swiglu(p, L.to_model(x, tp)), tp)
        return L.swiglu(L.gather_tree(p, specs, tp), x)

    # --------------------------------------------------------------- forward

    def _embed_inputs(self, params: PyTree, batch: Dict[str, torch.Tensor],
                      tp: Optional[L.ModelAxis]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(hidden (B, S, d), positions), JAX's ``_embed_inputs`` and the
        encdec branch of its ``forward``: the token embedding; for vlm the
        batch's ``vision_embeds`` (B, Pn, d) before it, with M-RoPE ids
        (3, B, S): the patches at t = 0 on an (h, w) grid of side
        int(sqrt(Pn)), the text at t = h = w = 1, 2, ...; positions (B, S)
        otherwise, broadcast to (3, B, S) under M-RoPE; for encdec the
        sinusoid added to the embedding."""
        cfg = self.cfg
        adt = _DTYPES[cfg.activation_dtype]
        tokens = batch["tokens"].long()
        if tp is None or L.spec_dim(self.param_specs()["embed"]) is None:
            h = params["embed"].to(adt)[tokens]
        else:
            h = L.vocab_parallel_embed(params["embed"], tokens, adt, tp)
        dev = h.device
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(adt)
            h = torch.cat([ve, h], dim=1)
            B, S, _ = h.shape
            Pn = ve.shape[1]
            side = max(int(math.sqrt(Pn)), 1)
            pidx = torch.arange(Pn, device=dev)
            text = torch.arange(S - Pn, device=dev) + 1
            pos3 = torch.stack([
                torch.cat([torch.zeros_like(pidx), text]),
                torch.cat([pidx // side, text]),
                torch.cat([pidx % side, text])])
            return h, pos3[:, None, :].expand(3, B, S)
        B, S, _ = h.shape
        pos = torch.arange(S, device=dev).expand(B, S)
        if cfg.mrope_sections:
            pos = pos.expand(3, B, S)
        if cfg.family == "encdec":
            h = h + sinusoid(S, cfg.d_model, adt, dev)
        return h, pos

    def _encode(self, params: PyTree, frames: torch.Tensor,
                tp: Optional[L.ModelAxis] = None) -> torch.Tensor:
        """The whisper-style encoder over the stub frame embeddings
        (B, F, d), JAX's ``_encode``: the frames plus the sinusoid in the
        activation dtype, non-causal attention without RoPE and SwiGLU a
        layer, then ``enc_norm``."""
        cfg = self.cfg
        adt = _DTYPES[cfg.activation_dtype]
        h = frames.to(adt) + sinusoid(frames.shape[1], cfg.d_model, adt,
                                      frames.device)
        B, S, _ = h.shape
        pos = torch.arange(S, device=h.device).expand(B, S)
        es = self._specs()["encoder"]

        def block(h, lp):
            h = h + self._attend(lp["attn"], es["attn"],
                                 L.rmsnorm(h, lp["ln1"], cfg.norm_eps), tp,
                                 positions=pos, theta=0.0, causal=False)
            return h + self._ffn(lp["mlp"], es["mlp"],
                                 L.rmsnorm(h, lp["ln2"], cfg.norm_eps), tp)

        block = self._remat(block)
        for lp in _per_layer(params["encoder"], cfg.encoder_layers):
            h = block(h, lp)
        return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)

    def _remat(self, block: Callable) -> Callable:
        """``block`` recomputed in the backward when ``cfg.remat`` (JAX's
        ``jax.checkpoint`` of each scanned block): its activations are not
        kept, and its values are the same bits.  It draws no random
        numbers, so no RNG state is saved."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return block
        return lambda *args: checkpoint(block, *args, use_reentrant=False,
                                        preserve_rng_state=False)

    def _decoder_blocks(self, params: PyTree, h: torch.Tensor,
                        positions: torch.Tensor, tp: Optional[L.ModelAxis],
                        enc_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stacked decoder blocks of the family (JAX's scan), in a
        loop over the layers.  The hybrid's shared block runs after every
        layer i with i % attn_every == attn_every - 1 (JAX's ``lax.cond``),
        its leaves' gradients summed over those runs.  Each block (the
        shared one with the layer it follows) is recomputed in the backward
        when ``cfg.remat`` (:meth:`_remat`).  Returns (hidden, aux loss
        summed over the layers; 0.0 but for moe)."""
        cfg = self.cfg
        attn_kw = dict(positions=positions, theta=cfg.rope_theta,
                       window=cfg.attn_window,
                       mrope_sections=cfg.mrope_sections, impl=cfg.attn_impl)
        ssm_kw = dict(d_inner=cfg.d_inner(), d_state=cfg.ssm_state,
                      n_heads=cfg.ssm_heads(), chunk=cfg.ssm_chunk,
                      norm_eps=cfg.norm_eps)
        specs = self._specs()
        ls = specs["layers"]
        aux = torch.zeros((), dtype=torch.float32, device=h.device)

        def block(h, aux, lp, i):
            if cfg.family in ("ssm", "hybrid"):
                h = h + L.mamba2_apply(
                    L.gather_tree(lp["mamba"], ls["mamba"], tp),
                    L.rmsnorm(h, lp["ln"], cfg.norm_eps), **ssm_kw)
                if cfg.family == "hybrid" \
                        and i % cfg.attn_every == cfg.attn_every - 1:
                    shared, ss = params["shared_attn"], specs["shared_attn"]
                    h = h + self._attend(
                        shared["attn"], ss["attn"],
                        L.rmsnorm(h, shared["ln1"], cfg.norm_eps), tp,
                        **attn_kw)
                    h = h + self._ffn(shared["mlp"], ss["mlp"], L.rmsnorm(
                        h, shared["ln2"], cfg.norm_eps), tp)
                return h, aux
            h = h + self._attend(lp["attn"], ls["attn"],
                                 L.rmsnorm(h, lp["ln1"], cfg.norm_eps), tp,
                                 **attn_kw)
            if cfg.family == "encdec":
                h = h + self._attend(
                    lp["xattn"], ls["xattn"],
                    L.rmsnorm(h, lp["ln2"], cfg.norm_eps), tp,
                    kv_src=enc_out, positions=positions, theta=0.0,
                    causal=False)
                h = h + self._ffn(lp["mlp"], ls["mlp"],
                                  L.rmsnorm(h, lp["ln3"], cfg.norm_eps), tp)
                return h, aux
            x = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                y, a = L.moe_apply(L.gather_tree(lp["moe"], ls["moe"], tp),
                                   x, n_experts=cfg.n_experts,
                                   k=cfg.experts_per_tok,
                                   capacity_factor=cfg.capacity_factor,
                                   groups=cfg.moe_groups)
                return h + y, aux + a
            return h + self._ffn(lp["mlp"], ls["mlp"], x, tp), aux

        block = self._remat(block)
        for i, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
            h, aux = block(h, aux, lp, i)
        return h, aux

    def forward_aux(self, params: PyTree, batch: Dict[str, torch.Tensor],
                    tp: Optional[L.ModelAxis] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits (B, S, V) in the activation
        dtype, aux loss), JAX's ``Model.forward``; on a ``model`` axis
        (``tp``) each rank's params are its shards, and the logits its vocab
        shard (B, S, V / M) where the head is vocab-sharded
        (:meth:`vocab_sharded`).  encdec reads the batch's ``frames``, vlm
        its ``vision_embeds`` (S then counts the patches too)."""
        cfg = self.cfg
        enc_out = self._encode(params, batch["frames"], tp) \
            if cfg.family == "encdec" else None
        h, pos = self._embed_inputs(params, batch, tp)
        h, aux = self._decoder_blocks(params, h, pos, tp, enc_out)
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        if self.vocab_sharded(tp):
            h = L.to_model(h, tp)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ head.to(h.dtype), aux

    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor],
                tp: Optional[L.ModelAxis] = None) -> torch.Tensor:
        """The logits of :meth:`forward_aux`."""
        return self.forward_aux(params, batch, tp)[0]

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor],
             tp: Optional[L.ModelAxis] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(ce + router_aux_weight * aux, {"ce": ..., "aux_loss": ...}), as
        JAX's ``Model.loss``; the aux loss is the moe family's load-balance
        loss summed over the layers (0.0 elsewhere, where the total is the
        cross-entropy itself).  On a ``model`` axis every rank of the axis
        gets the same value, by the vocab-parallel cross-entropy where the
        head is vocab-sharded."""
        logits, aux = self.forward_aux(params, batch, tp)
        labels = batch["labels"]
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            # no loss on the vision span
            pad = torch.full(labels.shape[:1]
                             + (batch["vision_embeds"].shape[1],), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        if self.vocab_sharded(tp):
            ce, _ = L.vocab_parallel_cross_entropy(logits, labels, tp)
        else:
            ce, _ = cross_entropy(logits, labels)
        total = ce + self.cfg.router_aux_weight * aux \
            if self.cfg.family == "moe" else ce
        return total, {"ce": ce, "aux_loss": aux}

    # ------------------------------------------------------------- serving

    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """The full-sequence forward's last-position logits (B, V)."""
        return self.forward(params, batch)[:, -1]

    def init_cache(self, batch_size: int, max_len: int,
                   device="cuda") -> PyTree:
        """The decode cache of ``batch_size`` lanes, zeros on ``device``,
        JAX's tree and layout (the lane axis 1 of every leaf): K/V (layers,
        B, C, K, hd) in the activation dtype, C = max_len or the window;
        the ssm's f32 ``state`` (layers, B, H, st, hp) and ``conv``
        (layers, B, d_conv - 1, d_inner + 2 st); the hybrid's ``mamba``
        entries and one ``shared`` K/V; encdec's ``self`` K/V and the
        ``cross_k``/``cross_v`` of the encoder's frames."""
        cfg = self.cfg
        dev = resolve_device(device)
        hd = cfg.hd()
        kvd = _DTYPES[cfg.activation_dtype]
        C = min(max_len, cfg.attn_window) if cfg.attn_window else max_len

        def zeros(*shape):
            return torch.zeros(shape, dtype=kvd, device=dev)

        def attn_cache(layers: int):
            return {"k": zeros(layers, batch_size, C, cfg.n_kv_heads, hd),
                    "v": zeros(layers, batch_size, C, cfg.n_kv_heads, hd)}

        if cfg.family in ("dense", "vlm", "moe"):
            return attn_cache(cfg.n_layers)
        if cfg.family in ("ssm", "hybrid"):
            mk = L.mamba2_cache_init(
                batch_size, d_inner=cfg.d_inner(), d_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads(), d_conv=cfg.ssm_conv, dtype=kvd,
                device=dev)
            mamba = {k: a.expand((cfg.n_layers,) + a.shape).clone()
                     for k, a in mk.items()}
            if cfg.family == "ssm":
                return mamba
            return {"mamba": mamba, "shared": attn_cache(1)}
        F = cfg.encoder_frames
        return {"self": attn_cache(cfg.n_layers),
                "cross_k": zeros(cfg.n_layers, batch_size, F,
                                 cfg.n_kv_heads, hd),
                "cross_v": zeros(cfg.n_layers, batch_size, F,
                                 cfg.n_kv_heads, hd)}

    def cache_specs(self) -> PyTree:
        """Each cache leaf's spec over the ``model`` axis (JAX's
        ``cache_specs``): the KV heads sharded when they divide the axis,
        else the head dim, else replicated; the SSM cache replicated."""
        cfg = self.cfg
        hd = cfg.hd()
        if cfg.n_kv_heads % L.MODEL_AXIS_SIZE == 0:
            kv = (None, None, None, MODEL, None)
        elif hd % L.MODEL_AXIS_SIZE == 0:
            kv = (None, None, None, None, MODEL)
        else:
            kv = (None,) * 5
        ssm = {"state": (None,) * 5, "conv": (None,) * 4}
        if cfg.family in ("dense", "vlm", "moe"):
            return {"k": kv, "v": kv}
        if cfg.family == "ssm":
            return ssm
        if cfg.family == "hybrid":
            return {"mamba": ssm, "shared": {"k": kv, "v": kv}}
        return {"self": {"k": kv, "v": kv}, "cross_k": kv, "cross_v": kv}

    def encode_cross_cache(self, params: PyTree, frames: torch.Tensor,
                           cache: PyTree) -> PyTree:
        """encdec: run the encoder over ``frames`` (B, F, d) and fill every
        layer's cross-attention K/V of ``cache`` (a new tree; the other
        entries are ``cache``'s)."""
        cfg = self.cfg
        if cfg.family != "encdec":
            raise ValueError(f"encode_cross_cache is encdec's; this model "
                             f"is {cfg.family}")
        enc = self._encode(params, frames)
        B = frames.shape[0]
        shape = (B, -1, cfg.n_kv_heads, cfg.hd())
        lays = _per_layer(params["layers"], cfg.n_layers)
        ck = torch.stack([(enc @ lp["xattn"]["wk"].to(enc.dtype))
                          .reshape(shape) for lp in lays])
        cv = torch.stack([(enc @ lp["xattn"]["wv"].to(enc.dtype))
                          .reshape(shape) for lp in lays])
        return {**cache, "cross_k": ck.to(cache["cross_k"].dtype),
                "cross_v": cv.to(cache["cross_v"].dtype)}

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    token: torch.Tensor, pos,
                    tp: Optional[L.ModelAxis] = None
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode of every lane (JAX's ``decode_step``, batched as
        its ``vmap`` over lanes runs it): token (B, 1) int, pos (B,) int
        (each lane's position) or one int for all.  Returns (logits (B, 1,
        V) in the activation dtype, the cache), the new entries written
        into ``cache``'s tensors in place.  moe dispatches each lane as its
        own group (capacity ``max(1, int(cf * k / E))``), as the per-lane
        step does; the hybrid's shared block runs after each layer i with
        i % attn_every == attn_every - 1, on its one K/V cache.

        On a ``model`` axis (``tp``) ``params`` and ``cache`` are this
        rank's shards (:meth:`param_specs`, :meth:`cache_specs`): a
        vocab-sharded embedding is looked up vocab-parallel, each layer's
        sharded leaves and K/V are gathered on use and its compute runs
        replicated, the rank's shard of the new K/V written back, and the
        logits are gathered whole."""
        cfg = self.cfg
        adt = _DTYPES[cfg.activation_dtype]
        hd = cfg.hd()
        token = token.long()
        dev = token.device
        B = token.shape[0]
        pos = torch.as_tensor(pos, device=dev).to(torch.int64)
        if pos.dim() == 0:
            pos = pos.expand(B)
        specs = self._specs()
        ls = specs["layers"]
        if tp is not None and L.spec_dim(specs["embed"]) is not None:
            h = L.vocab_parallel_embed(params["embed"], token, adt, tp)
        else:
            h = params["embed"].to(adt)[token]                # (B, 1, d)
        kv_dim = L.spec_dim(self.cache_specs()["cross_k"]
                            if cfg.family == "encdec" else
                            self.cache_specs()["shared"]["k"]
                            if cfg.family == "hybrid" else
                            self.cache_specs().get("k", (None,)))
        sharded = tp is not None and kv_dim is not None

        def whole(x):
            """A layer's K or V, gathered over the axis where sharded."""
            return tp.all_gather(x, kv_dim - 1) if sharded else x

        def keep(dst, x):
            """This rank's shard of an updated layer's K or V, written
            back (the cache itself was updated in place otherwise)."""
            if sharded:
                dst.copy_(tp.shard(x, kv_dim - 1))

        if cfg.family == "encdec":
            h = h + sinusoid_at(pos[:, None], cfg.d_model)[:, None].to(adt)
        attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=hd,
                       theta=cfg.rope_theta, window=cfg.attn_window)
        ssm_kw = dict(d_inner=cfg.d_inner(), d_state=cfg.ssm_state,
                      n_heads=cfg.ssm_heads(), norm_eps=cfg.norm_eps)
        kv = cache["self"] if cfg.family == "encdec" else cache
        for i, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
            lp = L.gather_tree(lp, ls, tp)
            if cfg.family in ("ssm", "hybrid"):
                mc = cache if cfg.family == "ssm" else cache["mamba"]
                y, new = L.mamba2_decode(
                    lp["mamba"], L.rmsnorm(h, lp["ln"], cfg.norm_eps),
                    {"state": mc["state"][i], "conv": mc["conv"][i]},
                    **ssm_kw)
                mc["state"][i] = new["state"]
                mc["conv"][i] = new["conv"]
                h = h + y
                if cfg.family == "hybrid" \
                        and i % cfg.attn_every == cfg.attn_every - 1:
                    shared = L.gather_tree(params["shared_attn"],
                                           specs["shared_attn"], tp)
                    sk, sv = cache["shared"]["k"], cache["shared"]["v"]
                    k0, v0 = whole(sk[0]), whole(sv[0])
                    y, _, _ = L.attention_decode(
                        shared["attn"],
                        L.rmsnorm(h, shared["ln1"], cfg.norm_eps),
                        k0, v0, pos, **attn_kw)
                    keep(sk[0], k0)
                    keep(sv[0], v0)
                    h = h + y
                    h = h + L.swiglu(shared["mlp"], L.rmsnorm(
                        h, shared["ln2"], cfg.norm_eps))
                continue
            ki, vi = whole(kv["k"][i]), whole(kv["v"][i])
            y, _, _ = L.attention_decode(
                lp["attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps),
                ki, vi, pos, mrope_sections=cfg.mrope_sections, **attn_kw)
            keep(kv["k"][i], ki)
            keep(kv["v"][i], vi)
            h = h + y
            if cfg.family == "encdec":
                h = h + L.attention(
                    lp["xattn"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps),
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=hd,
                    positions=torch.zeros((B, 1), dtype=torch.int64,
                                          device=dev),
                    theta=0.0, causal=False,
                    kv=(whole(cache["cross_k"][i]).to(h.dtype),
                        whole(cache["cross_v"][i]).to(h.dtype)))
                h = h + L.swiglu(lp["mlp"],
                                 L.rmsnorm(h, lp["ln3"], cfg.norm_eps))
                continue
            hn = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                y, _ = L.moe_apply(lp["moe"], hn, n_experts=cfg.n_experts,
                                   k=cfg.experts_per_tok,
                                   capacity_factor=cfg.capacity_factor,
                                   groups=B)
            else:
                y = L.swiglu(lp["mlp"], hn)
            h = h + y
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = h @ head.to(h.dtype)
        if self.vocab_sharded(tp):
            logits = tp.all_gather(logits, logits.dim() - 1)
        return logits, cache


MODEL = L.MODEL_AXIS


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """JAX's ``_sinusoid_at``: the f32 sinusoidal encoding (..., d) of the
    positions ``pos`` (..., 1), sin on the even channels and cos on the
    odd, its inverse frequencies by XLA's f32 exp (``random.xla_exp``)."""
    pos = pos.float()
    div = random.xla_exp(torch.arange(0, d, 2, dtype=torch.float32,
                                      device=pos.device)
                         * (-math.log(10000.0) / d))
    ang = pos * div
    pe = torch.zeros(pos.shape[:-1] + (d,), dtype=torch.float32,
                     device=pos.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang)
    return pe


def sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    """JAX's ``_sinusoid``: :func:`sinusoid_at` of positions 0..S-1,
    (S, d), cast to ``dtype``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    return sinusoid_at(pos, d).to(dtype)


def _per_layer(stacked: PyTree, n: int):
    """The n layers' param trees of a tree of stacked leaves.  One unbind
    per leaf: its backward stacks the n layer grads in one pass, where
    indexing a[i] in every layer would accumulate n full-size zero-padded
    grads."""
    per_leaf = [a.unbind(0) for a in T.leaves(stacked)]
    return [T.unflatten(stacked, [u[i] for u in per_leaf])
            for i in range(n)]


def _encoder_keys(key) -> Dict[str, np.ndarray]:
    """An encoder layer's keys by part, as JAX's vmapped ``enc_init(k)``
    splits them: two, then 4 for attention and 3 for the MLP."""
    k1, k2 = random.split(key)
    return {"enc_attn": random.split(k1, 4), "enc_mlp": random.split(k2, 3)}


def _layer_keys(family: str, key) -> Dict[str, np.ndarray]:
    """A layer's keys by part, as JAX's vmapped ``one(k)`` splits them:
    dense, vlm and moe split two, then 4 for attention (wq, wk, wv, wo)
    and 3 for the MLP (wg, wu, wd) or 4 for the experts (router, wg, wu,
    wd); encdec splits three: attention, cross-attention (4 each) and the
    MLP; ssm and hybrid split 8 for mamba2 (wz, wx, wB, wC, wdt, dt_bias,
    conv_w, wo)."""
    if family in ("ssm", "hybrid"):
        return {"mamba": random.split(key, 8)}
    if family == "encdec":
        k1, k2, k3 = random.split(key, 3)
        return {"attn": random.split(k1, 4), "xattn": random.split(k2, 4),
                "mlp": random.split(k3, 3)}
    k1, k2 = random.split(key)
    if family == "moe":
        return {"attn": random.split(k1, 4), "moe": random.split(k2, 4)}
    return {"attn": random.split(k1, 4), "mlp": random.split(k2, 3)}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

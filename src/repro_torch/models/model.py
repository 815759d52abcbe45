"""Config -> Model: init / forward / loss (``repro/models/model.py``).

Ported so far: the dense family (qwen2).  Params are a nested dict in the
JAX layout: per-layer weights stacked on a leading L axis, ``x @ W``
weights, the embedding reused as the LM head under tied embeddings.  The
leaf paths, shapes and flatten order therefore equal the JAX tree's, which
the wire's per-leaf layout depends on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
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


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.family != "dense":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not yet ported to "
                "repro_torch (ported: dense)")
        if cfg.attn_window or cfg.mrope_sections:
            raise NotImplementedError(
                "sliding-window attention and M-RoPE are not yet ported")
        if cfg.param_dtype != "float32":
            raise NotImplementedError("the port keeps f32 params")

    # ------------------------------------------------------------------ init

    def _build(self, make: Callable[[Tuple[int, ...], Optional[float]],
                                    torch.Tensor]) -> PyTree:
        """The params tree, each leaf from ``make(shape, scale)``: a normal
        draw times ``scale``, or ones for scale None.  Init distributions
        are the JAX package's (biases zero, norms one)."""
        cfg = self.cfg
        d, ff, V, Lr = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
        hd, nh, nkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
        attn = {
            "wq": make((Lr, d, nh * hd), 1.0 / math.sqrt(d)),
            "wk": make((Lr, d, nkv * hd), 1.0 / math.sqrt(d)),
            "wv": make((Lr, d, nkv * hd), 1.0 / math.sqrt(d)),
            "wo": make((Lr, nh * hd, d), 1.0 / math.sqrt(nh * hd)),
        }
        if cfg.qkv_bias:
            attn.update({"bq": make((Lr, nh * hd), 0.0),
                         "bk": make((Lr, nkv * hd), 0.0),
                         "bv": make((Lr, nkv * hd), 0.0)})
        params: Dict[str, Any] = {
            "embed": make((V, d), 0.02),
            "layers": {
                "attn": attn,
                "mlp": {"wg": make((Lr, d, ff), 1.0 / math.sqrt(d)),
                        "wu": make((Lr, d, ff), 1.0 / math.sqrt(d)),
                        "wd": make((Lr, ff, d), 1.0 / math.sqrt(ff))},
                "ln1": make((Lr, d), None),
                "ln2": make((Lr, d), None),
            },
            "final_norm": make((d,), None),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = make((d, V), 1.0 / math.sqrt(d))
        return params

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> PyTree:
        """Random f32 params on ``device``, drawn from ``generator`` (a
        ``torch.Generator`` on that device; seed 0 when None).  The draws
        differ from ``jax.random``'s; ``tree.params_from_jax`` carries
        JAX params across where equal params are needed."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def make(shape, scale):
            if scale is None:
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if scale == 0.0:
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            x = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            return x.mul_(scale)

        return self._build(make)

    def init_abstract(self) -> PyTree:
        """Params as ``meta`` tensors: shapes and dtypes, no storage."""
        return self._build(lambda shape, scale: torch.empty(
            shape, dtype=torch.float32, device="meta"))

    # --------------------------------------------------------------- forward

    def forward(self, params: PyTree, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, V) in the activation dtype."""
        cfg = self.cfg
        adt = _DTYPES[cfg.activation_dtype]
        tokens = batch["tokens"].long()
        h = params["embed"].to(adt)[tokens]
        B, S, _ = h.shape
        pos = torch.arange(S, device=h.device).expand(B, S)
        attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd(),
                       positions=pos, theta=cfg.rope_theta,
                       impl=cfg.attn_impl)
        # one unbind per stacked leaf: its backward stacks the L layer
        # grads in one pass, where indexing a[i] in every layer would
        # accumulate L full-size zero-padded grads
        stacked = T.leaves(params["layers"])
        per_layer = [a.unbind(0) for a in stacked]
        for i in range(cfg.n_layers):
            lp = T.unflatten(params["layers"], [u[i] for u in per_layer])
            h = h + L.attention(lp["attn"], L.rmsnorm(h, lp["ln1"],
                                                      cfg.norm_eps), **attn_kw)
            h = h + L.swiglu(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps))
        h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ head.to(h.dtype)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean cross-entropy, {"ce": ...}); the dense family has no
        auxiliary loss."""
        ce, _ = cross_entropy(self.forward(params, batch), batch["labels"])
        return ce, {"ce": ce}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

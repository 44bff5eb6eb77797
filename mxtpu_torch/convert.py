"""Weights across the packages: the JAX model's parameters, as numpy
arrays, into a state dict of the port's ``TransformerLM``."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_mxtpu"]

# _gen_params() layer key -> port module path
_LAYER_KEYS = {
    "ln1_g": "ln1.gamma", "ln1_b": "ln1.beta",
    "qw": "attn.q_proj.weight", "qb": "attn.q_proj.bias",
    "kw": "attn.k_proj.weight", "kb": "attn.k_proj.bias",
    "vw": "attn.v_proj.weight", "vb": "attn.v_proj.bias",
    "ow": "attn.out_proj.weight", "ob": "attn.out_proj.bias",
    "ln2_g": "ln2.gamma", "ln2_b": "ln2.beta",
    "f1w": "ffn1.weight", "f1b": "ffn1.bias",
    "f2w": "ffn2.weight", "f2b": "ffn2.bias",
}


def params_from_mxtpu(tree) -> dict:
    """``TransformerLM._gen_params()`` of the JAX model, every leaf a numpy
    array (the layout its serving engine consumes), as the ``state_dict``
    of a port ``TransformerLM`` of the same preset. Both packages store
    ``Dense`` weights as ``(out, in)``, so no leaf is transposed."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"embedding.weight": t(tree["embed"]), "pos_embed": t(tree["pos"]),
          "ln_f.gamma": t(tree["ln_f_g"]), "ln_f.beta": t(tree["ln_f_b"])}
    for i, layer in enumerate(tree["layers"]):
        for key, path in _LAYER_KEYS.items():
            sd[f"blocks.{i}.{path}"] = t(layer[key])
    if "head_w" in tree:
        sd["head.weight"] = t(tree["head_w"])
        sd["head.bias"] = t(tree["head_b"])
    return sd

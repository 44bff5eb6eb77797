"""Weights across the packages: the JAX model's parameters, as numpy
arrays, into a state dict of the port's ``TransformerLM``, and back; and
any Gluon block's parameters (a vision zoo net, say) as numpy arrays by
their names, the block prefix stripped, as its ``.params`` file keys them
in both packages."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_mxtpu", "params_to_mxtpu", "gluon_arrays",
           "load_gluon_arrays"]

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


def params_to_mxtpu(state_dict) -> dict:
    """The reverse of :func:`params_from_mxtpu`: a port ``TransformerLM``'s
    ``state_dict`` as numpy arrays in the JAX model's ``_gen_params()``
    layout, each leaf in its parameter's dtype (bf16 leaves as f32, which
    numpy lacks)."""
    def n(key):
        x = state_dict[key].detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    tree = {"embed": n("embedding.weight"), "pos": n("pos_embed"),
            "ln_f_g": n("ln_f.gamma"), "ln_f_b": n("ln_f.beta"),
            "layers": []}
    i = 0
    while f"blocks.{i}.ln1.gamma" in state_dict:
        tree["layers"].append({key: n(f"blocks.{i}.{path}")
                               for key, path in _LAYER_KEYS.items()})
        i += 1
    if "head.weight" in state_dict:
        tree["head_w"] = n("head.weight")
        tree["head_b"] = n("head.bias")
    return tree


def gluon_arrays(block) -> dict:
    """``block``'s initialized parameters as numpy arrays (bf16 as f32) by
    name, the block prefix stripped: the keys of its ``.params`` file. The
    arrays are copies: a later step does not move them."""
    out = {}
    for name, p in block.collect_params().items():
        if p._data is None:
            continue
        key = name[len(block.prefix):] if name.startswith(block.prefix) \
            else name
        x = p._tensor().detach().to("cpu", copy=True)
        out[key] = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return out


def load_gluon_arrays(block, arrays: dict, ctx=None) -> None:
    """Write numpy ``arrays`` (names with or without ``block``'s prefix)
    into its parameters in place, as ``load_parameters`` does; a parameter
    that holds nothing yet is created with the array's shape on its
    deferred device, else ``ctx`` (None: the card)."""
    from .gluon.parameter import _load_into
    from .ndarray.ndarray import NDArray
    params = block.collect_params()
    for key, arr in arrays.items():
        name = key if key in params else block.prefix + key
        if name not in params:
            raise KeyError(f"{key}: no such parameter in {block.prefix!r}")
        _load_into(params[name], NDArray(torch.tensor(np.asarray(arr))),
                   ctx)

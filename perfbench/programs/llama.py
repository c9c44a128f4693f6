"""How the port runs a Llama-style dense configuration on one card: its
TransformerConfig, its parameter tree over the benchmark's weights (named
as ``reference/llama.py``'s ``leaf_shapes`` names them) and its train step
(``make_train_step``, the hand-written flash attention, whose kernels
``KERNELS`` names)."""

from __future__ import annotations

KERNELS = ("flash_fwd_sm90", "flash_bwd_sm90")  # built with nvcc in set-up
LAYER_LEAVES = ("attn_scale", "wq", "wk", "wv", "wo", "mlp_scale", "w_gate",
                "w_up", "w_down")


def port_config(model: dict):
    """The port's TransformerConfig for a configuration file; raises where
    the file states what the port cannot run."""
    from dynolog_tpu_torch.models.transformer import TransformerConfig

    needs = {"hidden_act": "silu", "tie_word_embeddings": False,
             "rms_norm_eps": 1e-6, "rope_scaling": None,
             "num_key_value_heads": model["num_attention_heads"]}
    off = {k: model.get(k) for k, v in needs.items() if model.get(k) != v}
    if off:
        raise ValueError(f"the port cannot run these settings: {off}")
    return TransformerConfig(
        vocab_size=model["vocab_size"], d_model=model["hidden_size"],
        n_layers=model["num_hidden_layers"],
        n_heads=model["num_attention_heads"],
        d_ff=model["intermediate_size"],
        max_seq_len=model["max_position_embeddings"],
        rope_theta=float(model["rope_theta"]), dtype=model["torch_dtype"],
        attn_impl="flash")


def tree(weights: dict, model: dict) -> dict:
    """The port's parameter tree ({embedding, w_out, final_scale, layers})
    holding a copy of each weight, each a leaf that requires grad."""
    def leaf(name):
        return weights[name].detach().clone().requires_grad_(True)

    return {"embedding": leaf("embedding"), "w_out": leaf("w_out"),
            "final_scale": leaf("final_scale"),
            "layers": [{k: leaf(f"layers.{i}.{k}") for k in LAYER_LEAVES}
                       for i in range(model["num_hidden_layers"])]}


def leaves(params: dict) -> dict:
    """Leaf name -> the tree's tensor."""
    out = {k: params[k] for k in ("embedding", "w_out", "final_scale")}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def train_step(cfg):
    """The timed call: (params, optimizer, tokens) -> loss."""
    from dynolog_tpu_torch.models.train import make_train_step

    return make_train_step(cfg)

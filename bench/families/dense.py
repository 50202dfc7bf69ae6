"""The dense decoder-only transformer: pre-norm layers of attention (RoPE,
grouped KV heads) and an MLP (plain tanh-GELU or SwiGLU), a final norm and
an untied head."""
from __future__ import annotations

# the configuration files' activations -> the port's names
_ACT = {"gelu_pytorch_tanh": "gelu", "silu": "silu"}
# the port's norms have fixed epsilons (K1/K2's RMSNorm, the plain LayerNorm)
PORT_EPS = {"layernorm": 1e-5, "rmsnorm": 1e-6}


def matrix_shapes(conf: dict) -> list[tuple[str, str, tuple[int, int]]]:
    """(group, leaf, [in, out]) of one layer's matrices, in drawing order."""
    d, f, hd = conf["hidden_size"], conf["intermediate_size"], conf["head_dim"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    out = [("attn", "wq", (d, hq * hd)), ("attn", "wk", (d, hkv * hd)),
           ("attn", "wv", (d, hkv * hd)), ("attn", "wo", (hq * hd, d)),
           ("mlp", "w_up", (d, f)), ("mlp", "w_down", (f, d))]
    if conf["mlp_gated"]:
        out.append(("mlp", "w_gate", (d, f)))
    return out


def product_params(conf: dict) -> int:
    """N: the parameters of every product a token passes through (every
    layer's matrices and the output head; not the embedding lookup, not
    the norms)."""
    layer = sum(a * b for _, _, (a, b) in matrix_shapes(conf))
    return conf["num_hidden_layers"] * layer + conf["vocab_size"] * conf["hidden_size"]


def port_fields(conf: dict) -> dict:
    """The port's ``ModelConfig`` fields, checked against what the port
    can run."""
    if conf["position_encoding"] != "rope" or conf.get("linear_bias"):
        raise ValueError(f"{conf['name']}: the port runs RoPE layers without biases")
    if PORT_EPS[conf["norm"]] != conf["norm_eps"]:
        raise ValueError(f"{conf['name']}: the port's {conf['norm']} epsilon is "
                         f"{PORT_EPS[conf['norm']]}")
    return dict(
        name=conf["name"], arch_type="dense", num_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        hidden_act=_ACT[conf["hidden_act"]], glu=conf["mlp_gated"], norm=conf["norm"],
        rope_theta=conf["rope_theta"], tie_embeddings=conf["tie_word_embeddings"],
        dtype=conf["dtype"], param_dtype=conf.get("param_dtype", "float32"))

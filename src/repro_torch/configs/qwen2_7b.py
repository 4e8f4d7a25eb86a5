"""qwen2-7b [dense]: 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064. QKV bias, RoPE theta=1e6, SwiGLU, RMSNorm. [arXiv:2407.10671]"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab=152064,
        mlp="swiglu",
        qkv_bias=True,
        rope_theta=1e6,
    )

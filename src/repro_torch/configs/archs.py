"""The 10 architectures of the LM pool (public sources per entry), as in the
JAX package's `configs/archs.py`.

Known simplifications (documented; computational shapes preserved):
  * starcoder2/hubert use RMSNorm instead of parametric LayerNorm,
  * gemma2's GeGLU is realised as SwiGLU (identical matmul shapes),
  * jamba places its attention layer at index attn_period//2 of each
    8-layer block and MoE on odd sub-layers (1:7 attn:mamba, MoE every 2 —
    the arXiv:2403.19887 ratios).
"""
from __future__ import annotations

from ..models.mamba import MambaCfg
from ..models.moe import MoeCfg
from ..models.rwkv import RwkvCfg
from .base import ArchConfig

# [arXiv:2404.16821; hf] InternViT frontend is a stub (precomputed patch
# embeddings); backbone = InternLM2-20B geometry.
INTERNVL2_26B = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=92553, head_dim=128,
    rope_theta=1e6, frontend="vlm", n_patches=256)

# [arXiv:2402.19173; hf] GQA kv=2, RoPE, GeLU MLP.
STARCODER2_3B = ArchConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv=2, d_ff=12288, vocab=49152, head_dim=128,
    rope_theta=1e5, act="gelu")

# [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
MISTRAL_LARGE_123B = ArchConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv=8, d_ff=28672, vocab=32768, head_dim=128,
    rope_theta=1e6)

# [arXiv:2408.00118; hf] local(4096)/global alternating, attn softcap 50,
# final-logit softcap 30, head_dim 256, tied embeddings.
GEMMA2_9B = ArchConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv=8, d_ff=14336, vocab=256000, head_dim=256,
    window=4096, alt_local_global=True, softcap_attn=50.0,
    softcap_logits=30.0, tie_embeddings=True)

# [arXiv:2402.00838; hf] non-parametric LN, MHA, tied embeddings.
OLMO_1B = ArchConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv=16, d_ff=8192, vocab=50304, norm="nonparam",
    tie_embeddings=True)

# [arXiv:2403.19887; hf] Mamba+attn 1:7, MoE 16e top-2 every 2 layers.
JAMBA_15_LARGE_398B = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv=8, d_ff=24576, vocab=65536, head_dim=128,
    attn_period=8, moe_period=2,
    moe=MoeCfg(n_experts=16, top_k=2, d_ff=24576),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2))

# [arXiv:2106.07447; unverified] encoder-only; conv feature extractor is a
# stub (precomputed frame embeddings); masked-unit prediction over 504 units.
HUBERT_XLARGE = ArchConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv=16, d_ff=5120, vocab=504, encoder_only=True,
    causal=False, frontend="audio", act="gelu")

# [arXiv:2404.05892; hf] Finch: attention-free, data-dependent decay.
RWKV6_3B = ArchConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    rwkv=RwkvCfg(head_dim=64))

# [hf:microsoft/Phi-3.5-MoE-instruct; hf] 16 experts top-2 every layer.
PHI35_MOE_42B = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=6400, vocab=32064, head_dim=128,
    moe=MoeCfg(n_experts=16, top_k=2, d_ff=6400))

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 60 routed top-4 + 4 shared experts.
QWEN2_MOE_A27B = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=151936,
    moe=MoeCfg(n_experts=60, top_k=4, d_ff=1408, n_shared=4))

ALL_ARCHS = {
    a.name: a for a in [
        INTERNVL2_26B, STARCODER2_3B, MISTRAL_LARGE_123B, GEMMA2_9B,
        OLMO_1B, JAMBA_15_LARGE_398B, HUBERT_XLARGE, RWKV6_3B,
        PHI35_MOE_42B, QWEN2_MOE_A27B,
    ]
}

"""MLP widths past the presets', for the wide fused layer kernels (products
past 512 columns), and the attention head widths the kernels are held at,
shared by the port's CPU and card tests. Imports no JAX.

"w1024" is dulcet-universe at twice its MLP widths: the coupling MLPs, the
augmenter's conditioner and net, and the embedder's head 1,024 wide, every
other key the preset's. "w2048" widens those MLPs to 2,048 (four times the
preset's) and sets the latent and the LayerNorm's row (`attn_input_dim`) to
1,024: products with K = 2,048 (the wide kernels' input in two halves) and
row-wise epilogues over two passes of 512 columns, B2's output layer at
2,036 columns (four passes); `cif_latent_dim` follows the latent, as in the
preset (no CIF blocks). "pre1024" is dulcet-universe with a 1,024-wide
conditioner pre-MLP (B1's and B5's conditioner kinds past 512).
chip_smoke.py keeps its own copies of W1024 and W2048 (it runs from a
checkout without the tests).
"""

from __future__ import annotations

import flowcompare_tpu_torch as ft

W1024 = {"hidden_dims": [1024] * 3, "net_augmenter_dist_hidden_dims": [1024] * 3,
         "hidden_dims_embedder_out": [1024] * 6}
W2048 = {"hidden_dims": [2048] * 3, "net_augmenter_dist_hidden_dims": [2048] * 3,
         "hidden_dims_embedder_out": [2048] * 6, "latent_dim": 1024, "attn_input_dim": 1024,
         "cif_latent_dim": 1024}
PRE1024 = {"pre_attention_mlp_hidden_dims": [1024] * 3}
WIDE_CONFIGS = {"w1024": W1024, "w2048": W2048, "pre1024": PRE1024}

# head widths D = heads x dim_head: every tile width of the attention
# kernels (32, 64, 128, 256, 512) and widths between them, among them
# widths that are no multiple of 8 (v = kv[:, D:] then starts off 16-byte
# alignment) and odd ones (a row's last column stored alone); past 512 the
# cluster tier's: a last block of one box (520, its 8 columns; 576), of a
# box and a ragged one (1,001, odd), 768 (6 blocks) and 1,024 (8 blocks,
# the most a portable cluster holds)
ATTENTION_SWEEP = (8, 20, 21, 32, 48, 64, 96, 128, 129, 192, 256, 384, 447, 512, 520, 576, 768,
                   1001, 1024)


def preset_config(preset: str) -> dict:
    """A preset's config, or dulcet-universe with a WIDE_CONFIGS entry's widths."""
    if preset in WIDE_CONFIGS:
        return {**ft.get_config("dulcet-universe"), **WIDE_CONFIGS[preset]}
    return ft.get_config(preset)

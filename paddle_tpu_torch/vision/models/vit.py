"""Vision Transformer (counterpart of ``paddle_tpu/vision/models/vit.py``):
``PatchEmbed``, ``MLP``, ``Block`` on ``nn.MultiHeadAttention``,
``VisionTransformer`` and the ViT-B/16 and ViT-L/16 builders
(Dosovitskiy et al. 2021, Table 1).

The attention is non-causal and unmasked over the class token and the
patches (T = 197 at 224 x 224 with patch 16): on CUDA tensors the
flash-attention kernels K1 / K2 (head dim 64 for both builders), on CPU
tensors their dense plain version."""
from __future__ import annotations

import torch

from ... import tensor as T
from ...nn import GELU, Dropout, LayerNorm
from ...nn.layer import Layer, LayerList, create_parameter
from ...nn.layers.conv import Conv2D
from ...nn.layers.transformer import MultiHeadAttention
from ._common import layer_kw, linear, no_pretrained


class PatchEmbed(Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, **kw):
        super().__init__()
        kw = kw or layer_kw()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                           stride=patch_size, **kw)

    def forward(self, x):
        x = self.proj(x)                                    # [B, E, H', W']
        b, e = x.shape[0], x.shape[1]
        return T.transpose(T.reshape(x, [b, e, -1]), [0, 2, 1])  # [B, N, E]


class MLP(Layer):
    def __init__(self, dim, hidden, drop=0.0, **kw):
        super().__init__()
        kw = kw or layer_kw()
        self.fc1 = linear(dim, hidden, **kw)
        self.act = GELU()
        self.fc2 = linear(hidden, dim, **kw)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class Block(Layer):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, drop=0.0,
                 attn_drop=0.0, **kw):
        super().__init__()
        kw = kw or layer_kw()
        self.norm1 = LayerNorm(dim, 1e-6, **kw)
        self.attn = MultiHeadAttention(dim, num_heads, attn_drop, **kw)
        self.norm2 = LayerNorm(dim, 1e-6, **kw)
        self.mlp = MLP(dim, int(dim * mlp_ratio), drop, **kw)

    def forward(self, x):
        x = T.add(x, self.attn(self.norm1(x)))
        return T.add(x, self.mlp(self.norm2(x)))


class VisionTransformer(Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, drop_rate=0.0, attn_drop_rate=0.0,
                 device=None, dtype=None, generator=None, seed=0, **kwargs):
        super().__init__()
        kw = layer_kw(device, dtype or torch.float32, generator, seed)
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        n = self.patch_embed.num_patches
        self.cls_token = create_parameter((1, 1, embed_dim), **kw)
        self.pos_embed = create_parameter((1, n + 1, embed_dim), **kw)
        self.pos_drop = Dropout(drop_rate)
        self.blocks = LayerList([
            Block(embed_dim, num_heads, mlp_ratio, drop_rate, attn_drop_rate,
                  **kw) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim, 1e-6, **kw)
        self.head = (linear(embed_dim, num_classes, **kw)
                     if num_classes > 0 else None)

    def forward(self, x):
        x = self.patch_embed(x)
        b = x.shape[0]
        cls = T.expand(self.cls_token, [b, 1, self.cls_token.shape[2]])
        x = T.concat([cls, x], axis=1)
        x = self.pos_drop(T.add(x, self.pos_embed))
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        cls_out = x[:, 0]
        return self.head(cls_out) if self.head is not None else cls_out


def vit_b_16(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kwargs)


def vit_l_16(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16,
                             **kwargs)


__all__ = ["Block", "MLP", "PatchEmbed", "VisionTransformer", "vit_b_16",
           "vit_l_16"]

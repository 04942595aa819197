from .adaptor import CrossAttentionHfcPatch
from .decoder import BoxDecoder, TwoWayTransformer
from .detector import WildlifeMapper
from .pos_embed import PositionEmbeddingRandom
from .vit import ImageEncoderViT

__all__ = [
    "WildlifeMapper", "ImageEncoderViT", "BoxDecoder", "TwoWayTransformer",
    "CrossAttentionHfcPatch", "PositionEmbeddingRandom",
]

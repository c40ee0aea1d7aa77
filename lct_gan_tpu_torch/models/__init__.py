from lct_gan_tpu_torch.models.attention import MultiHeadSelfAttention
from lct_gan_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                     MultiScaleDiscriminator)
from lct_gan_tpu_torch.models.generator import (FreqGRUBlock,
                                                LCTGeneratorConfig,
                                                LctEnhancer, LctGenerator,
                                                TimeGRUBlock)
from lct_gan_tpu_torch.models.layers import LayerNorm

__all__ = ["FreqGRUBlock", "LCTGeneratorConfig", "LayerNorm", "LctEnhancer",
           "LctGenerator", "MultiHeadSelfAttention", "MultiPeriodDiscriminator",
           "MultiScaleDiscriminator", "TimeGRUBlock"]

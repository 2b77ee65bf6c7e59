from .fog import (FOG_PRESETS, EnhancedFogSynthesizer, box_mean,
                  gaussian_blur, guided_filter, rand_perlin)

__all__ = ["FOG_PRESETS", "EnhancedFogSynthesizer", "box_mean",
           "gaussian_blur", "guided_filter", "rand_perlin"]

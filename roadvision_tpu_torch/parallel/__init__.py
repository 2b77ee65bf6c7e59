from .inference import (GatedStreamStep, make_gated_stream_step,
                        make_stream_step)

__all__ = ["GatedStreamStep", "make_gated_stream_step", "make_stream_step"]

from .draw import (COLOR_TABLE, TrailRenderer, draw_detections,
                   draw_keypoints,
                   draw_masks, draw_overlays, draw_rboxes, draw_rect,
                   fill_rect, make_canvas, put_text, text_size,
                   tile_streams)

__all__ = ["draw_detections", "draw_masks", "draw_keypoints",
           "draw_rboxes", "draw_overlays", "make_canvas", "COLOR_TABLE",
           "draw_rect", "fill_rect", "put_text", "text_size",
           "tile_streams", "TrailRenderer"]

from .generator import (  # noqa: F401
    COLOR_POOL,
    blend_image_from_mask,
    get_bbox_from_mask,
    image_blending,
    mask_to_segmentation_coords,
    video_blending_keyframes,
)

from .projector import (HomographyProjector, build_projector,
                        distance_device, find_homography_dlt,
                        project_boxes_device, project_points_device)

__all__ = ["HomographyProjector", "build_projector", "distance_device",
           "find_homography_dlt", "project_boxes_device",
           "project_points_device"]

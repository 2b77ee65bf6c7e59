from .projector import (GroundProjector, HomographyProjector, build_projector,
                        distance_device, find_homography_dlt,
                        project_boxes_device, project_points_device)

__all__ = ["GroundProjector", "HomographyProjector", "build_projector",
           "distance_device", "find_homography_dlt", "project_boxes_device",
           "project_points_device"]

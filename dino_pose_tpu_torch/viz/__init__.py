"""Visualisation: skeleton overlays, 3-D scatter, combined views (counterpart
of dino_pose_tpu/viz). matplotlib is imported inside the functions, so this
package imports without it."""

from dino_pose_tpu_torch.viz.plots import (  # noqa: F401
    plot_keypoints,
    plot_3d_keypoints,
    plot_keypoints_combined,
    visualize_pose,
    fig_to_array,
)

"""Ops of the port's models, channels-last, with their hand-written kernels."""

from .conv2d import conv2d_same
from .conv3d import conv3d_s2, conv3d_same, deconv3d_k3s2
from .corr import corr1d, corr1d_reference
from .cost_volume import concat_cost_volume, concat_cost_volume_reference
from .fused_costvol import cost_volume_conv3x3, cost_volume_conv3x3_reference
from .gradients import (
    c_ds1,
    c_ds2,
    c_ds3,
    c_ds3t,
    c_ds3t1,
    c_imdiff1,
    diff1_dx,
    diff1_dy,
    diff2_dx,
    diff2_dy,
    diff_z_dx,
    diff_z_dy,
)
from .regression import trilinear_soft_argmin
from .resize import interp_matrix, resize_bilinear, resize_trilinear, upsample2x
from .softargmin import soft_argmin
from .ssim import gaussian_kernel_1d, ssim_map
from .warp import imwarp, warp_disparity

__all__ = [
    "conv2d_same",
    "conv3d_same",
    "conv3d_s2",
    "deconv3d_k3s2",
    "corr1d",
    "corr1d_reference",
    "concat_cost_volume",
    "concat_cost_volume_reference",
    "cost_volume_conv3x3",
    "cost_volume_conv3x3_reference",
    "diff1_dx",
    "diff1_dy",
    "diff2_dx",
    "diff2_dy",
    "diff_z_dx",
    "diff_z_dy",
    "c_imdiff1",
    "c_ds1",
    "c_ds2",
    "c_ds3",
    "c_ds3t",
    "c_ds3t1",
    "trilinear_soft_argmin",
    "interp_matrix",
    "resize_bilinear",
    "resize_trilinear",
    "upsample2x",
    "soft_argmin",
    "gaussian_kernel_1d",
    "ssim_map",
    "imwarp",
    "warp_disparity",
]

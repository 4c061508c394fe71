"""Front-end stages ahead of the solver (counterparts of
psulvsb_tpu/frontend/): neighbours, normals, the normal-angle pre-filter,
the voxel grid, ISS keypoints, FPFH features, the matcher and ICP."""

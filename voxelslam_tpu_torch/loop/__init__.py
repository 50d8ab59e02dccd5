"""Loop closure: BTC place recognition, ICP, pose graph (port of
`voxelslam_tpu/loop/`)."""

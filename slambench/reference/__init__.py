"""The plain reference that decides `correct`: NumPy in float64, one file
a layer it covers. It imports nothing of the program and takes nothing the
program made except the outputs it judges.

    poses.py    odometry, loop closure and GBA: emitted poses and the
                relative poses of loop and GBA edges against the
                generator's ground truth
    moments.py  the voxel map: per-voxel moments of a step's inserted
                scans against a plain accumulation of its downsampled
                points, by voxel key
    ransac.py   loop closure's geometric verification (BTC RANSAC and
                plane overlap), recomputed from the descriptors it got
"""

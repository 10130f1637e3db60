"""Fixed tables of the SMPL body model and the evaluation joints.

Copied from the published SMPL and SPIN conventions (the kinematic tree, the
21 surface keypoints, the 49-joint output order, the H36M J14 subset) and
ImageNet's normalisation. The benchmark hands these same tables to the
program when it builds its SMPL model, and the reference reads them here.
"""

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_BETAS = 10

# parent of each of the 24 joints (-1: the root)
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
           12, 13, 14, 16, 17, 18, 19, 20, 21)

# mesh vertices read as keypoints: face 5, feet 6, hand tips 10
VERTEX_JOINT_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617,
                    6624, 6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782,
                    5905, 6016, 6133)

# the 49-joint output, as indices into [24 skeleton joints, 21 vertex
# keypoints, 9 regressed extra joints]
JOINT_MAP = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26,
             27, 28, 29, 30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17,
             16, 18, 20, 47, 48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27)

# the 14 evaluation joints among the 17 H36M joints
H36M_TO_J14 = (6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

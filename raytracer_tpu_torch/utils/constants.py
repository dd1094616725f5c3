"""Global sentinel constants.

Same semantics as the reference's sightpy/utils/constants.py:1-4, but the
miss sentinel is float32-representable: the wavefront integrator runs in
float32 on TPU, where the reference's 1e39 would overflow to inf.
"""

# Hit orientation codes: a ray entering a closed surface hits it UPWARDS
# (front face); a ray leaving hits it UPDOWN (back face).
UPWARDS = 1
UPDOWN = -1

# Distance returned by an intersection test on a miss.  Any distance >=
# MISS_THRESHOLD is treated as "no hit".
FARAWAY = 1.0e30
MISS_THRESHOLD = 1.0e29

# Radius of the environment geometry (skybox cube / panorama sphere).
SKYBOX_DISTANCE = 1.0e6

# Surface offset applied when respawning secondary rays so they do not
# immediately re-intersect the surface they started from (reference nudges
# by 1e-6 in every material, e.g. glossy.py:35).
NUDGE_EPS = 1.0e-6

# Wavelengths (nm) used for the 3-channel spectral approximation of
# complex-IoR absorption (reference ray.py:22-29, refractive.py:114-122).
WAVELENGTHS_NM = (630.0, 550.0, 475.0)

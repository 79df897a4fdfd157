"""Plain PyTorch and NumPy reference of what each cell's timed path derives:
robot forward kinematics and its voxels, the depth insert (hits, the exact
visibility carve, the saturating int8 log-odds update), the workcell map,
motion-check states and collision counts. It imports nothing of the
program under test and takes nothing the program made: it works from the
benchmark's inputs and the configuration alone.
"""

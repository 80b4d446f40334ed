"""The benchmark's plain reference, written from the published semantics of
the steps that the cells time (``segment.py``: segmentation, the segment
table and the classes; ``frame.py``: the viewer's frame) in NumPy, SciPy
and CPU PyTorch on the host.  It imports nothing of the port, of the JAX
package or of JAX, and takes nothing the port computed: only the stand's
points, the configuration file's sections and the camera's transform.
"""

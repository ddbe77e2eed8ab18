"""Launch layer of the port: the training and serving entry points
(``python -m repro_torch.launch.train`` / ``... .serve``; ``--model-axis``
trains on a ``(data, model)`` mesh of the visible cards), the production
mesh shapes (``mesh``), the shape cells and their meta-tensor input specs
(``specs``) and the chip-free roofline arithmetic (``roofline``). The
reference's ahead-of-time dry run (``dryrun.py``: XLA compiles on fake
devices and their memory analysis) has no counterpart here."""
from . import mesh, roofline, specs
from .mesh import make_production_mesh
from .roofline import Roofline
from .specs import SHAPES, ShapeCell, cell_applicable

__all__ = ["mesh", "roofline", "specs", "make_production_mesh", "Roofline",
           "SHAPES", "ShapeCell", "cell_applicable"]

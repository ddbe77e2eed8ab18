"""Launch layer of the port: the training and serving entry points
(``python -m repro_torch.launch.train`` / ``... .serve``; ``--model-axis``
trains on a ``(data, model)`` mesh of the visible cards), the production
mesh shapes (``mesh``), the shape cells and their meta-tensor input specs
(``specs``), the chip-free roofline arithmetic (``roofline``) and the
reference's ahead-of-time dry run (``dryrun``: ``python -m
repro_torch.launch.dryrun``), which runs each cell once under PyTorch's
``FakeTensorMode`` on fake meshes of 256 and 512 positions and counts its
per-position memory, flops, bytes and collective bytes, as the reference's
XLA compiles on fake devices and their analyses do. No card is needed."""
import importlib

from . import mesh, roofline, specs
from .mesh import make_production_mesh
from .roofline import Roofline
from .specs import SHAPES, ShapeCell, cell_applicable

__all__ = ["dryrun", "mesh", "roofline", "specs", "make_production_mesh",
           "Roofline", "SHAPES", "ShapeCell", "cell_applicable"]


def __getattr__(name):
    # imported on first use, so that ``python -m repro_torch.launch.dryrun``
    # does not find the module imported before it runs
    if name == "dryrun":
        return importlib.import_module(f"{__name__}.dryrun")
    raise AttributeError(name)

from . import model
from .config import SHAPES, ArchConfig, MoESettings, ShapeConfig

from .model import VoltaForVLTasks, VoltaModel

__all__ = ["VoltaModel", "VoltaForVLTasks"]

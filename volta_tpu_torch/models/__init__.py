from .model import VoltaForVLPreTraining, VoltaForVLTasks, VoltaModel

__all__ = ["VoltaModel", "VoltaForVLTasks", "VoltaForVLPreTraining"]

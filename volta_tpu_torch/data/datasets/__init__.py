"""Dataset registry of the port (volta_tpu/data/datasets/__init__.py:16-41).

Only the soft-target QA datasets of ``qa.py`` are ported; any other task
name raises ``NotImplementedError``.
"""

from .qa import (GQAClassificationDataset, GenomeQAClassificationDataset,
                 VQAClassificationDataset)


class _Registry(dict):
    def __missing__(self, name):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md Queue 1 item 4, "
            "eval path, the rest)")


DatasetMapTrain = _Registry({
    "VQA": VQAClassificationDataset,
    "GenomeQA": GenomeQAClassificationDataset,
    "GQA": GQAClassificationDataset,
})

DatasetMapEval = _Registry(DatasetMapTrain)

__all__ = ["DatasetMapTrain", "DatasetMapEval", "VQAClassificationDataset",
           "GQAClassificationDataset", "GenomeQAClassificationDataset"]

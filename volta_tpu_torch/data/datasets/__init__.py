"""Dataset registry of the port (volta_tpu/data/datasets/__init__.py:16-41).

The same keys as the JAX package's ``DatasetMapTrain`` and
``DatasetMapEval``, each mapped to the port's copy of its dataset; the
retrieval tasks evaluate on ``RetrievalDatasetVal``. A name the registry
lacks raises ``KeyError``, as a dict does.
"""

from .dense_caption import ReferDenseCaptionDataset, VisMadLibsDataset
from .guesswhat import GuessWhatDataset
from .nlvr2 import NLVR2Dataset
from .pointing import (FlickrGroundingDataset, GuessWhatPointingDataset,
                       Visual7wPointingDataset)
from .qa import (GQAClassificationDataset, GenomeQAClassificationDataset,
                 VQAClassificationDataset)
from .refer_expression import ReferExpressionDataset
from .retrieval import RetrievalDataset, RetrievalDatasetVal
from .vcr import VCRDataset
from .visdial import VisDialDataset
from .visual_entailment import VisualEntailmentDataset

DatasetMapTrain = {
    "VQA": VQAClassificationDataset,
    "GenomeQA": GenomeQAClassificationDataset,
    "GQA": GQAClassificationDataset,
    "VCR_Q-A": VCRDataset,
    "VCR_QA-R": VCRDataset,
    "NLVR2": NLVR2Dataset,
    "VisualEntailment": VisualEntailmentDataset,
    "RetrievalCOCO": RetrievalDataset,
    "RetrievalFlickr30k": RetrievalDataset,
    "refcoco": ReferExpressionDataset,
    "refcoco+": ReferExpressionDataset,
    "refcocog": ReferExpressionDataset,
    "GuessWhat": GuessWhatDataset,
    "Visual7w": Visual7wPointingDataset,
    "GuessWhatPointing": GuessWhatPointingDataset,
    "FlickrGrounding": FlickrGroundingDataset,
    # unregistered in the reference (dead code there); functional here
    "VisualDialog": VisDialDataset,
    "ReferDenseCaption": ReferDenseCaptionDataset,
    "VisMadLibs": VisMadLibsDataset,
}

DatasetMapEval = dict(DatasetMapTrain)
DatasetMapEval["RetrievalCOCO"] = RetrievalDatasetVal
DatasetMapEval["RetrievalFlickr30k"] = RetrievalDatasetVal

__all__ = [
    "DatasetMapTrain", "DatasetMapEval",
    "VQAClassificationDataset", "GQAClassificationDataset",
    "GenomeQAClassificationDataset", "NLVR2Dataset", "VCRDataset",
    "VisualEntailmentDataset", "RetrievalDataset", "RetrievalDatasetVal",
    "ReferExpressionDataset", "GuessWhatDataset", "Visual7wPointingDataset",
    "GuessWhatPointingDataset", "FlickrGroundingDataset", "VisDialDataset",
    "ReferDenseCaptionDataset", "VisMadLibsDataset",
]

from repro_torch.data.loader import Loader
from repro_torch.data.synthetic import SyntheticCorpus

__all__ = ["Loader", "SyntheticCorpus"]

from repro_torch.data.synthetic import SyntheticCorpus, token_batches  # noqa: F401
from repro_torch.data.loader import ShardedLoader  # noqa: F401

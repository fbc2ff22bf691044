"""The data path — counterpart of ``paddle_tpu/io`` with the reference's
exports: datasets and samplers (copies), the DataLoader (worker threads
and forked worker processes, numpy only), the device prefetch (pinned
memory, a side CUDA stream) and the native token-bin reader."""
from paddle_tpu_torch.io.dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from paddle_tpu_torch.io.sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)
from paddle_tpu_torch.io.dataloader import (DataLoader,  # noqa: F401
                                            WorkerInfo, default_collate_fn,
                                            get_worker_info)
from paddle_tpu_torch.io.prefetch import (DevicePrefetch,  # noqa: F401
                                          prefetch_to_device)
from paddle_tpu_torch.io.token_bin import TokenBinDataset  # noqa: F401

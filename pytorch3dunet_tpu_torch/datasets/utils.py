"""Test loaders for the port: pytorch3dunet_tpu/datasets/utils.py
`get_test_loaders` without its jax import, for one process.

The datasets and the loader are the JAX package's own numpy host tier,
reused by import. The HDF5 datasets need h5py, which is imported only here.
"""

from pytorch3dunet_tpu.datasets.loader import DataLoader
from pytorch3dunet_tpu.datasets.utils import default_prediction_collate
from pytorch3dunet_tpu.utils.misc import get_class, get_logger

logger = get_logger("Dataset")


def get_test_loaders(config: dict):
    """Yields one loader per test file (reference: datasets/utils.py:426-475)."""
    assert "loaders" in config, "Could not find data loaders configuration"
    loaders_config = config["loaders"]

    logger.info("Creating test set loaders...")
    dataset_cls_str = loaders_config.get("dataset", None)
    if dataset_cls_str is None:
        dataset_cls_str = "StandardHDF5Dataset"
        logger.warning(f"Cannot find dataset class in the config. Using default '{dataset_cls_str}'.")
    dataset_class = get_class(dataset_cls_str, modules=["pytorch3dunet_tpu.datasets.hdf5"])
    test_datasets = dataset_class.create_datasets(loaders_config, phase="test")

    num_workers = loaders_config.get("num_workers", 1)
    batch_size = loaders_config.get("batch_size", 1)
    logger.info(f"Number of workers for the dataloader: {num_workers}, batch size: {batch_size}")
    # threads by default: forking a process that runs torch's thread pools is unsafe
    worker_mode = loaders_config.get("worker_mode", "thread")
    for test_dataset in test_datasets:
        collate_fn = getattr(test_dataset, "prediction_collate", default_prediction_collate)
        yield DataLoader(test_dataset, batch_size=batch_size, num_workers=num_workers, collate_fn=collate_fn,
                         worker_mode=worker_mode)

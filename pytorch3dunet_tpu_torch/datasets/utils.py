"""Train and test loaders for the port: pytorch3dunet_tpu/datasets/utils.py
`get_train_loaders` and `get_test_loaders` without their jax imports, for one
process.

The datasets and the loader are the JAX package's own numpy host tier,
reused by import. The HDF5 datasets need h5py, which is imported only here.
"""

from pytorch3dunet_tpu.datasets.loader import ConcatDataset, DataLoader
from pytorch3dunet_tpu.datasets.utils import default_prediction_collate
from pytorch3dunet_tpu.utils.misc import get_class, get_logger

logger = get_logger("Dataset")


def _dataset_class(loaders_config: dict):
    dataset_cls_str = loaders_config.get("dataset", None)
    if dataset_cls_str is None:
        dataset_cls_str = "StandardHDF5Dataset"
        logger.warning(f"Cannot find dataset class in the config. Using default '{dataset_cls_str}'.")
    return get_class(dataset_cls_str, modules=["pytorch3dunet_tpu.datasets.hdf5"])


def get_train_loaders(config: dict, seed: int | None = None) -> dict:
    """Builds {'train': loader, 'val': loader} from config['loaders']
    (reference: datasets/utils.py:268-347): the train loader shuffles (from
    `seed`, or numpy's global RNG when None), the val loader does not."""
    assert "loaders" in config, "Could not find data loaders configuration"
    loaders_config = config["loaders"]
    if loaders_config.get("device_augment", False):
        raise NotImplementedError("loaders.device_augment is not ported to PyTorch yet (ROADMAP Queue 1 item 11)")
    assert set(loaders_config["train"]["file_paths"]).isdisjoint(loaders_config["val"]["file_paths"]), (
        "Train and validation 'file_paths' overlap. One cannot use validation data for training!"
    )

    logger.info("Creating training and validation set loaders...")
    dataset_class = _dataset_class(loaders_config)
    train_datasets = dataset_class.create_datasets(loaders_config, phase="train")
    val_datasets = dataset_class.create_datasets(loaders_config, phase="val")

    num_workers = loaders_config.get("num_workers", 1)
    batch_size = loaders_config.get("batch_size", 1)
    logger.info(f"Number of workers for train/val dataloader: {num_workers}, batch size: {batch_size}")
    # threads by default: forking a process that runs torch's thread pools is unsafe
    worker_mode = loaders_config.get("worker_mode", "thread")
    return {
        "train": DataLoader(ConcatDataset(train_datasets), batch_size=batch_size, shuffle=True,
                            num_workers=num_workers, drop_last=loaders_config.get("drop_last", False), seed=seed,
                            worker_mode=worker_mode),
        "val": DataLoader(ConcatDataset(val_datasets), batch_size=batch_size, shuffle=False,
                          num_workers=num_workers, worker_mode=worker_mode),
    }


def get_test_loaders(config: dict):
    """Yields one loader per test file (reference: datasets/utils.py:426-475)."""
    assert "loaders" in config, "Could not find data loaders configuration"
    loaders_config = config["loaders"]

    logger.info("Creating test set loaders...")
    test_datasets = _dataset_class(loaders_config).create_datasets(loaders_config, phase="test")

    num_workers = loaders_config.get("num_workers", 1)
    batch_size = loaders_config.get("batch_size", 1)
    logger.info(f"Number of workers for the dataloader: {num_workers}, batch size: {batch_size}")
    # threads by default: forking a process that runs torch's thread pools is unsafe
    worker_mode = loaders_config.get("worker_mode", "thread")
    for test_dataset in test_datasets:
        collate_fn = getattr(test_dataset, "prediction_collate", default_prediction_collate)
        yield DataLoader(test_dataset, batch_size=batch_size, num_workers=num_workers, collate_fn=collate_fn,
                         worker_mode=worker_mode)

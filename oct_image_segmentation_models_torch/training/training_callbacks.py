"""Per-epoch stats, counterpart of the JAX package's
``training/training_callbacks.py``.

Writes a rolling ``stats_epoch{NN}.hdf5`` after each epoch (deleting the
previous epoch's file) with the same dataset keys
(train_acc/val_acc/train_loss/val_loss/epoch_time), and the training
curve plot. The stats files go through :mod:`..common.h5`; matplotlib is
imported where the plot is drawn.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from ..common import h5, plotting


class SaveEpochInfo:
    def __init__(self, save_folder: Path, train_params, start_epoch: int = 0):
        # On exact resume (training.py, resume_train_state) the curves
        # for the epochs that ran in the previous process are not
        # re-derivable here; NaN placeholders keep the absolute epoch
        # alignment of the stats datasets and the curve plot (matplotlib
        # renders NaN as a gap).
        nan = [float("nan")] * start_epoch
        self.train_losses = list(nan)
        self.train_accs = list(nan)
        self.val_losses = list(nan)
        self.val_accs = list(nan)
        self.epoch_times = list(nan)
        self.start_epoch_time = -1.0
        self.start_time = -1.0
        self.train_time = -1.0
        self.acc_name = train_params.metric
        self.loss_name = train_params.loss
        self.save_folder = Path(save_folder)
        self.plotpath = self.save_folder / "performance_plot.png"
        self.num_epochs = train_params.epochs
        self.network_name = (
            train_params.model_architecture or "resumed_model"
        )

    def on_train_begin(self):
        self.start_time = time.time()

    def on_train_end(self):
        self.train_time = time.time() - self.start_time

    def on_epoch_begin(self, epoch):
        self.start_epoch_time = time.time()

    def on_epoch_end(self, epoch, logs):
        self.train_losses.append(logs.get("loss"))
        self.train_accs.append(logs.get(self.acc_name))
        self.val_losses.append(logs.get("val_loss"))
        self.val_accs.append(logs.get("val_" + self.acc_name))
        self.epoch_times.append(time.time() - self.start_epoch_time)

        with h5.File(
            self.save_folder / f"stats_epoch{epoch + 1:02d}.hdf5", "w"
        ) as f:
            f["train_acc"] = self.train_accs
            f["val_acc"] = self.val_accs
            f["train_loss"] = self.train_losses
            f["val_loss"] = self.val_losses
            f["epoch_time"] = self.epoch_times

        prev = self.save_folder / f"stats_epoch{epoch:02d}.hdf5"
        if os.path.isfile(prev):
            try:
                os.remove(prev)
            except OSError:
                pass

        plotting.save_cur_trainval_plot(
            self.acc_name,
            self.loss_name,
            self.network_name,
            self.num_epochs,
            epoch,
            self.train_accs,
            self.val_accs,
            self.train_losses,
            self.val_losses,
            self.plotpath,
        )

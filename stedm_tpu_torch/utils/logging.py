"""Metrics/event logging behind a thin interface.

The reference logs everything to Weights & Biases (reference `train_diff.py:42`,
`modules/ldm_diffusion.py:213-221`, `modules/segmentation.py:160-330`). W&B needs
egress, so the default sink here is a JSONL event log + stdout; when
``location.wandb`` is true and the package imports, the same events mirror to W&B
(scalars, images, tables map 1:1 to the reference's surface).

A copy of stedm_tpu/utils/logging.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class EventLogger:
    def __init__(self, run_dir: str | Path, run_name: str, *, use_wandb: bool = False,
                 config: dict | None = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        self._file = open(self.run_dir / "events.jsonl", "a", encoding="utf-8")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                # run-id persistence: resuming a training run re-attaches to the
                # same W&B run (reference ldm_diffusion.py:122-125 stashes the id
                # in hparams; here it lives next to the event log)
                id_file = self.run_dir / "wandb_id.txt"
                kwargs = {}
                if id_file.is_file():
                    kwargs = dict(id=id_file.read_text().strip(), resume="allow")
                self._wandb = wandb.init(project="stedm_tpu", name=run_name,
                                         config=config or {}, **kwargs)
                id_file.write_text(self._wandb.id)
            except Exception as exc:  # pragma: no cover - needs egress
                print(f"[logging] wandb unavailable ({exc}); using JSONL only")

    def log(self, metrics: dict, step: int | None = None) -> None:
        scalars = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        record = {"ts": time.time(), "step": step, **scalars}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        printable = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in scalars.items())
        print(f"[{self.run_name}] step={step} {printable}", flush=True)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_images(self, key: str, images, step: int | None = None) -> None:
        """Save preview images under run_dir/previews (wandb mirror if enabled)."""
        import numpy as np
        from PIL import Image

        out = self.run_dir / "previews"
        out.mkdir(exist_ok=True)
        paths = []
        for i, img in enumerate(images):
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = ((np.clip(arr, -1, 1) + 1) * 127.5).astype(np.uint8)
            p = out / f"{key.replace(' ', '_')}_{step}_{i}.png"
            Image.fromarray(arr).save(p)
            paths.append(str(p))
        self.log({f"{key}": paths}, step=step)
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: [wandb.Image(p) for p in paths]}, step=step)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """``EventLogger``'s surface for the ranks other than 0, which log
    nothing (train_diff.py:142, :211): no file, no print, no W&B."""

    def __init__(self, run_dir: str | Path, run_name: str, **_):
        self.run_dir = Path(run_dir)
        self.run_name = run_name

    def log(self, metrics: dict, step: int | None = None) -> None:
        pass

    def log_images(self, key: str, images, step: int | None = None) -> None:
        pass

    def close(self) -> None:
        pass

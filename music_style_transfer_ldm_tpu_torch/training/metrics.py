"""Metric logging: a CSV of per-epoch metrics (resumable) and loss-curve
plots, which are skipped where matplotlib is not installed."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional, Sequence


def _maybe_float(v: str):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricLogger:
    def __init__(self, csv_path: str | Path, resume: bool = False,
                 truncate_from_epoch: Optional[int] = None):
        """resume=True reloads an existing CSV (history plots stay complete
        and new rows append) instead of truncating it — used by the
        trainer's resume_from path.

        truncate_from_epoch: on resume, drop reloaded rows whose 'epoch'
        is >= this value.  A checkpoint restart replays epochs from the
        checkpointed step, so rows the previous process logged past that
        point would otherwise be duplicated (twice per epoch number, with
        conflicting values, desynchronizing the plots' x-axis).
        """
        self.csv_path = Path(csv_path)
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        self.rows: list[dict] = []
        self._fieldnames: list[str] | None = None
        if resume and self.csv_path.exists():
            with open(self.csv_path, newline="") as f:
                reader = csv.DictReader(f)
                self._fieldnames = list(reader.fieldnames or []) or None
                for row in reader:
                    self.rows.append({k: _maybe_float(v)
                                      for k, v in row.items()})
            if truncate_from_epoch is not None:
                kept = [r for r in self.rows
                        if not (isinstance(r.get("epoch"), float)
                                and r["epoch"] >= truncate_from_epoch)]
                if len(kept) != len(self.rows):
                    self.rows = kept
                    self._rewrite()

    def _rewrite(self) -> None:
        """Rewrite the whole CSV from self.rows with self._fieldnames."""
        if self._fieldnames is None:
            return
        with open(self.csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames,
                                    restval="", extrasaction="ignore")
            writer.writeheader()
            writer.writerows(self.rows)

    def log(self, **metrics) -> None:
        self.rows.append(metrics)
        if self._fieldnames is None:
            self._fieldnames = list(metrics.keys())
            self._rewrite()
        elif set(metrics) - set(self._fieldnames):
            # A newer version logs keys absent from the resumed header:
            # widen the header and rewrite (old rows get empty cells)
            # instead of letting DictWriter raise mid-training.
            self._fieldnames += [k for k in metrics
                                 if k not in self._fieldnames]
            self._rewrite()
        else:
            with open(self.csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames, restval="",
                               extrasaction="ignore").writerow(metrics)
        parts = [f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                 for k, v in metrics.items()]
        print("[metrics] " + " ".join(parts), flush=True)

    def plot(self, out_path: str | Path, keys: Sequence[str],
             logscale: bool = False) -> None:
        """Loss curves, linear or log scale.  No-op without matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        plt.figure(figsize=(10, 5))
        for k in keys:
            ys = [r[k] for r in self.rows if k in r]
            plt.plot(ys, label=k)
        if logscale:
            plt.yscale("log")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.grid(True)
        plt.legend()
        plt.savefig(out_path)
        plt.close()

"""Audio acquisition from YouTube with yt-dlp (and FFmpeg to extract the
audio).

Both are optional and imported only when a download starts: without
yt-dlp a download raises a clear error.  A URL that still fails after
``retries`` more attempts is recorded in ``failures`` and reported at the
end of a batch, and the batch goes on.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional, Tuple


class AudioDownloader:
    """Downloads into ``output_dir/<instrument>/<title>.<audio_format>``."""

    def __init__(self, output_dir: str = "downloads",
                 audio_format: str = "mp3", retries: int = 2):
        self.output_dir = Path(output_dir)
        self.audio_format = audio_format
        self.retries = retries
        self.failures: List[Tuple[str, str]] = []

    def _ydl_opts(self, out_dir: Path) -> dict:
        """Best audio, extracted by FFmpeg to ``audio_format`` at 192k."""
        return {
            "format": "bestaudio/best",
            "outtmpl": str(out_dir / "%(title)s.%(ext)s"),
            "postprocessors": [{
                "key": "FFmpegExtractAudio",
                "preferredcodec": self.audio_format,
                "preferredquality": "192",
            }],
            "quiet": True,
            "noprogress": True,
        }

    def download_audio(self, url: str, instrument: str = "",
                       title: Optional[str] = None) -> Optional[Path]:
        """Download one URL into ``output_dir/<instrument>/``; returns the
        directory on success, None on failure (recorded)."""
        try:
            import yt_dlp
        except ImportError as e:
            raise RuntimeError(
                "yt-dlp is not installed; acquisition requires network "
                "tooling unavailable in this environment") from e

        out_dir = (self.output_dir / instrument if instrument
                   else self.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        opts = self._ydl_opts(out_dir)
        if title:
            opts["outtmpl"] = str(out_dir / f"{title}.%(ext)s")

        last_err = None
        for _ in range(self.retries + 1):
            try:
                with yt_dlp.YoutubeDL(opts) as ydl:
                    ydl.download([url])
                return out_dir
            except Exception as e:  # noqa: BLE001 — recorded, batch goes on
                last_err = e
        self.failures.append((url, str(last_err)))
        return None

    def download_from_file(self, filepath: str) -> None:
        """One URL per line (blank lines and ``#`` comments skipped)."""
        urls = [ln.strip() for ln in Path(filepath).read_text().splitlines()
                if ln.strip() and not ln.startswith("#")]
        for url in urls:
            self.download_audio(url)
        self.report_failures()

    def download_from_csv(self, filepath: str) -> None:
        """CSV rows ``instrument,title,url`` (a header row and ``#``
        comments skipped)."""
        with open(filepath) as f:
            rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
        if rows and rows[0][:1] == ["instrument"]:
            rows = rows[1:]
        for row in rows:
            instrument, title, url = (row[0].strip(), row[1].strip(),
                                      row[2].strip())
            self.download_audio(url, instrument=instrument, title=title)
        self.report_failures()

    def report_failures(self) -> None:
        if not self.failures:
            print("All downloads completed successfully.")
            return
        print(f"{len(self.failures)} download(s) failed:")
        for url, err in self.failures:
            print(f"  {url}: {err}")

"""Live audio capture: the AudioReceiver / mic2mfcc ingest role.

The reference receives a live I2S microphone in gateware
(reference mfcc/io/audio.py, targets/mic2mfcc.py:19-41).  A TPU host
has no I2S bus; the native equivalent is the platform capture stack, driven
as a subprocess that writes raw mono int16 PCM to stdout.  Any of the
standard capture tools works; the first one present is used:

    arecord -q -f S16_LE -c 1 -r <rate> [-D <device>] -t raw -
    ffmpeg -loglevel quiet -f alsa -i <device> -f s16le -ac 1 -ar <rate> -
    sox -q -d -t raw -b 16 -e signed -c 1 -r <rate> -
    parec --format=s16le --channels=1 --rate=<rate>

``command`` overrides detection (also how tests inject a fake device).
"""

from __future__ import annotations

import shutil
import subprocess

import numpy as np


def capture_command(rate: int = 16000, device: str | None = None
                    ) -> list[str] | None:
    """argv of the first available capture tool, or None."""
    if shutil.which("arecord"):
        cmd = ["arecord", "-q", "-f", "S16_LE", "-c", "1", "-r", str(rate),
               "-t", "raw"]
        if device:
            cmd += ["-D", device]
        return cmd + ["-"]
    if shutil.which("ffmpeg"):
        return ["ffmpeg", "-loglevel", "quiet", "-f", "alsa",
                "-i", device or "default", "-f", "s16le", "-ac", "1",
                "-ar", str(rate), "-"]
    if shutil.which("sox"):
        return ["sox", "-q", "-d", "-t", "raw", "-b", "16", "-e", "signed",
                "-c", "1", "-r", str(rate), "-"]
    if shutil.which("parec"):
        cmd = ["parec", "--format=s16le", "--channels=1", f"--rate={rate}"]
        if device:
            cmd.append(f"--device={device}")
        return cmd
    return None


class Capture:
    """A running capture subprocess yielding int16 sample blocks."""

    def __init__(self, rate: int = 16000, device: str | None = None,
                 command: list[str] | None = None):
        argv = command or capture_command(rate, device)
        if argv is None:
            raise RuntimeError(
                "no capture tool found (arecord/ffmpeg/sox/parec); pass an "
                "explicit command that writes raw mono int16 PCM to stdout")
        self.argv = argv
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL)
        self._tail = b""

    def read(self, n_samples: int) -> np.ndarray:
        """Block until n_samples are captured; shorter only at EOF."""
        need = 2 * n_samples - len(self._tail)
        data = self._tail
        while need > 0:
            blk = self.proc.stdout.read(need)
            if not blk:
                break
            data += blk
            need -= len(blk)
        usable = len(data) - (len(data) % 2)
        self._tail = data[usable:]
        return np.frombuffer(data[:usable], dtype="<i2")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self.proc.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

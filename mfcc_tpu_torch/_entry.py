"""Console-script shims mirroring the reference's entry points
(reference setup.py:25-31: wav2mfcc, mic2mfcc, mfcc-sim), the counterparts
of ``mfcc_tpu._entry`` over this package's ``cli.main``."""

import sys

from . import cli


def wav2mfcc():
    """Batch converter (32 cepstra): wav2mfcc <dir>."""
    return sys.exit(cli.main(["convert", *sys.argv[1:]]))


def mic2mfcc():
    """Live stream (16 cepstra): mic2mfcc <infile> [outfile]."""
    return sys.exit(cli.main(["stream", "--ncep", "16", *sys.argv[1:]]))


def mfcc_sim():
    """Pipeline self-test against the oracles."""
    return sys.exit(cli.main(["selftest", *sys.argv[1:]]))

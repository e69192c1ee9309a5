"""CLI argument parsing (copy of emg3d_tpu/cli/main.py; reference
emg3d/cli/main.py:28-229)."""

import argparse
import os
import sys

from emg3d_tpu_torch import utils
from emg3d_tpu_torch.cli import run


def main(args=None):
    """Parse command-line inputs and dispatch to :func:`run.simulation`."""
    if args is None:
        args = sys.argv[1:]

    parser = argparse.ArgumentParser(
        description=(
            "Multigrid solver for 3D electromagnetic diffusion on a "
            "CUDA card (PyTorch port of emg3d-tpu)."))

    parser.add_argument(
        "config", nargs="?", default="emg3d.cfg", type=str,
        help="name of config file; default is 'emg3d.cfg'")
    parser.add_argument(
        "-n", "--nproc", type=int, default=None,
        help="number of parallel tasks (API-parity; device-executed)")

    group1 = parser.add_mutually_exclusive_group()
    group1.add_argument("-f", "--forward", action='store_true',
                        help="compute synthetic data (default)")
    group1.add_argument("-m", "--misfit", action='store_true',
                        help="compute synthetic data and their misfit")
    group1.add_argument("-g", "--gradient", action='store_true',
                        help="compute synthetic data, misfit, and gradient")

    parser.add_argument("--path", type=str, default=None,
                        help="path; file names are relative to path")
    parser.add_argument("--survey", type=str, default=None,
                        help="input survey file name (default 'survey.h5')")
    parser.add_argument("--model", type=str, default=None,
                        help="input model file name (default 'model.h5')")
    parser.add_argument("--output", type=str, default=None,
                        help="output files base name (default 'emg3d_out')")
    parser.add_argument("--save", type=str, default=None,
                        help="file name to save the simulation")
    parser.add_argument("--load", type=str, default=None,
                        help="file name to load a simulation")
    parser.add_argument("--cache", type=str, default=None,
                        help="shortcut for --load --save with one file")
    parser.add_argument("--clean", action="store_true", default=False,
                        help="replace model and computed data of a "
                             "loaded simulation")
    parser.add_argument("-l", "--layered", action="store_true", default=None,
                        help="use a layered (1-D) model per src-rec pair")
    parser.add_argument("-d", "--dry-run", action="store_true",
                        default=False,
                        help="only display what would have been done")

    group3 = parser.add_mutually_exclusive_group()
    group3.add_argument("--verbosity", type=int, default=0,
                        choices=[-1, 0, 1, 2], help="set verbosity")
    group3.add_argument("-v", "--verbose", action="count", dest="verbosity",
                        help="increase verbosity")
    group3.add_argument("-q", "--quiet", action="store_const", const=-1,
                        dest="verbosity", help="decrease verbosity")

    parser.add_argument("--report", action="store_true", default=False,
                        help="only display the environment report")
    parser.add_argument("--version", action="store_true", default=False,
                        help="only display the version")

    args_dict = vars(parser.parse_args(args))

    if args_dict.pop('version'):
        from emg3d_tpu_torch import __version__
        print(f"emg3d-torch v{__version__} (emg3d_tpu_torch)")
        return

    if args_dict.pop('report'):
        print(utils.Report())
        return

    # Bare invocation without a config file: print the pointer instead
    # of failing (checks the effective args, not sys.argv, so
    # programmatic cli([...]) calls are never hijacked).
    if not args and not os.path.isfile('emg3d.cfg'):
        from emg3d_tpu_torch import __version__
        print(parser.description)
        print(f"=> Type `emg3d-torch --help` for more info "
              f"(emg3d-torch v{__version__}).")
        return

    run.simulation(args_dict)


if __name__ == "__main__":
    sys.exit(main())

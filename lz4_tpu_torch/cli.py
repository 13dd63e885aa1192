"""lz4-compatible command-line interface (the port's own copy of
lz4_tpu/cli.py): the L5 layer.

    python -m lz4_tpu_torch.cli [arg] [input] [output]

Flag-grammar parity with programs/lz4cli.c:447-708: -1..-12, --fast[=#],
-d/-z/-t/-b/-l, -c/-f/-q/-v, -m/-r, -B4..7 / -B#bytes (exact custom
block sizes, lz4io.c:286-300) / -BD/-BI/-BX, -D dict, --content-size,
--no-frame-crc, --sparse/--no-sparse, --rm, --list, -T#/--threads, env
vars LZ4_CLEVEL / LZ4_NBWORKERS (lz4cli.c:363-391), argv[0] aliases
lz4cat / unlz4 / lz4c legacy commands (lz4cli.c:433-444, 523-530),
console-safety refusals (lz4cli.c:771-828).

The heavy lifting lives in lz4_tpu_torch.io.engine (L4) and the block
backends. `--backend cuda` (the default) runs `TorchBackend` on the GPU
and exits with an error where there is none; `--backend host` runs the
host C tier (`HostBackend`). Nothing falls back from one to the other.
"""
from __future__ import annotations

import os
import sys

from lz4_tpu_torch.block.backend import default_nb_workers
from lz4_tpu_torch.constants import (BLOCK_SIZES, LZ4HC_CLEVEL_MAX,
                                     optimal_block_size_id)
from lz4_tpu_torch.io.engine import (
    IoError,
    IoPrefs,
    compress_file,
    decompress_file,
    expand_paths,
    format_list_output,
)

PROGRAM = "lz4-torch"
USAGE = f"""Usage: {PROGRAM} [arg] [input] [output]
input/output defaults to stdin/stdout; `-` means stdin/stdout.

Arguments:
 -1..-12   compression level (1 fast, default; 2..12 HC tiers)
 --fast[=#] ultra-fast mode (acceleration #, default 1)
 -d        decompression (default for .lz4 extension)
 -z        force compression
 -t        test compressed file integrity
 -b#       benchmark file(s), level #
 -l        legacy lz4 format (0x184C2102)
 -D FILE   use FILE as dictionary
 -f        overwrite output without prompting
 -c        force write to stdout
 -m        multiple input files (implies -c off)
 -r        recurse directories (implies -m)
 -B#       block size [4-7] (default 7 = 4MB) or exact bytes (32..4MB)
 -BD       dependent/linked blocks
 -BI       independent blocks (default; cancels -BD)
 -BX       enable block checksums
 --no-frame-crc    disable content checksum
 --content-size    store uncompressed size in frame header
 --sparse / --no-sparse   sparse file support (default on)
 --rm      remove source file after success
 --list    list frame info of .lz4 files (with -m for several)
 -T#       host worker threads (0 = auto: cores - 1 - cores/8; default
           auto, or LZ4_NBWORKERS); the host C tier's pool under either
           backend
 --backend cuda|host  block-codec backend (default cuda: the GPU)
 -q        quiet; -v verbose
 -V        display version
 -h/-H     this help
"""
VERSION = "lz4-torch 0.1.0 (formats: LZ4 frame v1.6.x compatible)"


class CliError(SystemExit):
    def __init__(self, msg: str, code: int = 1):
        sys.stderr.write(f"{PROGRAM}: {msg}\n")
        super().__init__(code)


def _select_backend(name: str | None, nb_workers: int = 0):
    """The block backend `--backend` names: `TorchBackend` on the GPU by
    default (an error where there is none), or `HostBackend`; either's
    host tier runs on `nb_workers` threads."""
    if name in (None, "cuda"):
        from lz4_tpu_torch.parallel.engine import TorchBackend
        try:
            return TorchBackend(nb_workers=nb_workers)
        except RuntimeError as e:
            raise CliError(f"{e} (or use --backend host)")
    if name == "host":
        from lz4_tpu_torch.block.backend import HostBackend
        return HostBackend(nb_workers=nb_workers)
    raise CliError(f"unknown backend {name!r} (cuda or host)")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0]) if argv else PROGRAM
    args = argv[1:]

    mode = "auto"            # auto|compress|decompress|test|bench|list
    prefs = IoPrefs()
    level_env = os.environ.get("LZ4_CLEVEL")
    if level_env and level_env.isdigit():
        prefs.level = int(level_env)
    # the reference CLI runs cores - 1 - cores/8 workers by default
    # (lz4io.c:177-187); LZ4_NBWORKERS and -T# override, -T1 is serial
    prefs.nb_workers = default_nb_workers()
    nbw_env = os.environ.get("LZ4_NBWORKERS")
    if nbw_env and nbw_env.isdigit():
        prefs.nb_workers = int(nbw_env)
    multiple = False
    recursive = False
    force_stdout = False
    backend_name = None
    bench_levels: list[int] = []
    files: list[str] = []

    # argv[0] aliases (lz4cli.c:433-444)
    lz4c_legacy = False
    if prog == "lz4cat":
        mode = "decompress"
        force_stdout = True
        prefs.overwrite = True
        prefs.pass_through = True
        prefs.remove_src_file = False
        prefs.verbosity = 1
        multiple = True
    elif prog == "unlz4":
        mode = "decompress"
    elif prog == "lz4c":
        # legacy command set enabled (-c0/-c1/-c2/-hc/-y)
        lz4c_legacy = True

    i = 0
    while i < len(args):
        a = args[i]
        i += 1
        if a == "--":
            files.extend(args[i:])
            break
        if not a.startswith("-") or a == "-":
            files.append(a)
            continue
        if lz4c_legacy and a in ("-c0", "-c1", "-c2", "-hc", "-y"):
            # lz4c legacy commands (lz4cli.c:523-530)
            if a == "-c0":
                prefs.level = 1
            elif a == "-c1":
                prefs.level = 9
            elif a in ("-c2", "-hc"):
                prefs.level = 12
            else:
                prefs.overwrite = True
            continue
        if a.startswith("--"):
            opt = a[2:]
            if opt == "help":
                print(USAGE)
                return 0
            elif opt == "version":
                print(VERSION)
                return 0
            elif opt == "compress":
                mode = "compress"
            elif opt in ("decompress", "uncompress"):
                mode = "decompress"
            elif opt == "test":
                mode = "test"
            elif opt == "list":
                mode = "list"
            elif opt == "force":
                prefs.overwrite = True
            elif opt == "stdout" or opt == "to-stdout":
                force_stdout = True
            elif opt == "multiple":
                multiple = True
            elif opt == "recursive":
                recursive = multiple = True
            elif opt == "quiet":
                prefs.verbosity = max(0, prefs.verbosity - 1)
            elif opt == "verbose":
                prefs.verbosity += 1
            elif opt == "keep":
                prefs.remove_src_file = False
            elif opt == "rm":
                prefs.remove_src_file = True
            elif opt == "sparse":
                prefs.sparse_file_support = True
            elif opt == "no-sparse":
                prefs.sparse_file_support = False
            elif opt == "content-size":
                prefs.content_size_flag = True
            elif opt == "no-content-size":
                prefs.content_size_flag = False
            elif opt == "no-frame-crc":
                prefs.stream_checksum = False
            elif opt == "no-crc":
                prefs.stream_checksum = False
                prefs.block_checksum = False
            elif opt == "favor-decSpeed":
                prefs.favor_dec_speed = True
            elif opt.startswith("max-dist="):
                # extension: cap match offsets (wave-friendly streams
                # for the 128-lane lockstep device decoder; the
                # favor-decSpeed trade taken further; standard format)
                v = int(opt[9:])
                if not 1 <= v <= 65535:
                    raise CliError(f"invalid --max-dist {v}")
                prefs.max_dist = v
            elif opt == "fast" or opt.startswith("fast="):
                mode = "compress" if mode == "auto" else mode
                prefs.level = 1
                prefs.acceleration = int(opt[5:]) if "=" in opt else 1
            elif opt.startswith("threads="):
                prefs.nb_workers = int(opt[8:])
            elif opt.startswith("backend="):
                backend_name = opt[8:]
            elif opt == "backend":
                if i >= len(args):
                    raise CliError("--backend needs an argument")
                backend_name = args[i]
                i += 1
            else:
                raise CliError(f"unknown option --{opt}")
            continue
        # bundled short options
        j = 1
        while j < len(a):
            c = a[j]
            j += 1
            if c.isdigit():
                lvl = c
                while j < len(a) and a[j].isdigit():
                    lvl += a[j]
                    j += 1
                prefs.level = min(int(lvl), LZ4HC_CLEVEL_MAX)
            elif c == "z":
                mode = "compress"
            elif c == "d":
                mode = "decompress"
            elif c == "t":
                mode = "test"
            elif c == "f":
                prefs.overwrite = True
            elif c == "c":
                force_stdout = True
            elif c == "k":
                prefs.remove_src_file = False
            elif c == "m":
                multiple = True
            elif c == "r":
                recursive = multiple = True
            elif c == "q":
                prefs.verbosity = max(0, prefs.verbosity - 1)
            elif c == "v":
                prefs.verbosity += 1
            elif c == "V":
                print(VERSION)
                return 0
            elif c in ("h", "H"):
                print(USAGE)
                return 0
            elif c == "l":
                prefs.legacy_format = True
            elif c == "D":
                rest = a[j:]
                j = len(a)
                if not rest:
                    if i >= len(args):
                        raise CliError("-D needs a dictionary file")
                    rest = args[i]
                    i += 1
                prefs.dictionary_filename = rest
            elif c == "T":
                num = ""
                while j < len(a) and a[j].isdigit():
                    num += a[j]
                    j += 1
                # -T0 means auto (the reference's semantics)
                prefs.nb_workers = (int(num) if num and int(num) > 0
                                    else default_nb_workers())
            elif c == "b":
                mode = "bench"
                num = ""
                while j < len(a) and a[j].isdigit():
                    num += a[j]
                    j += 1
                bench_levels = [int(num)] if num else [prefs.level]
            elif c == "e":
                num = ""
                while j < len(a) and a[j].isdigit():
                    num += a[j]
                    j += 1
                if bench_levels and num:
                    bench_levels = list(range(bench_levels[0],
                                              int(num) + 1))
            elif c == "i":
                # -i#: minimum seconds per bench timing loop
                num = ""
                while j < len(a) and a[j].isdigit():
                    num += a[j]
                    j += 1
                if not num:
                    raise CliError("-i needs a number of seconds")
                prefs.bench_seconds = float(num)
            elif c == "B":
                # block-property loop: -B accepts chained D/I/X/size
                # properties (lz4cli.c:612-649, e.g. -B4D)
                while j < len(a):
                    if a[j] == "D":
                        prefs.block_independence = False
                        j += 1
                    elif a[j] == "I":
                        prefs.block_independence = True
                        j += 1
                    elif a[j] == "X":
                        prefs.block_checksum = True
                        j += 1
                    elif a[j].isdigit():
                        num = ""
                        while j < len(a) and a[j].isdigit():
                            num += a[j]
                            j += 1
                        v = int(num)
                        if v < 4 or (7 < v < 32):
                            raise CliError(f"invalid block size {v}")
                        if v <= 7:
                            prefs.block_size_id = v
                            prefs.block_custom_size = None
                        else:
                            # exact custom byte size, clamped to the
                            # 4 MB format ceiling (lz4io.c:286-300);
                            # the frame advertises the covering tier
                            v = min(v, BLOCK_SIZES[7])
                            prefs.block_custom_size = v
                            prefs.block_size_id = optimal_block_size_id(v)
                    else:
                        break
                # a bare -B with no property is a no-op, matching the
                # reference property loop (lz4cli.c:612-649)
            else:
                raise CliError(f"unknown option -{c}")
    return _dispatch(mode, prefs, files, multiple, recursive,
                     force_stdout, backend_name, bench_levels)


def _dispatch(mode, prefs, files, multiple, recursive, force_stdout,
              backend_name, bench_levels) -> int:
    if mode == "list":              # reads frame headers only: no backend
        if not files:
            raise CliError("--list needs at least one file")
        print(format_list_output(expand_paths(files, recursive),
                                 prefs.verbosity >= 3))
        return 0

    backend = _select_backend(backend_name, prefs.nb_workers)

    if mode == "bench":
        from lz4_tpu_torch.bench_harness import bench_files
        bench_files(files or ["-"], bench_levels or [1], prefs,
                    backend=backend,
                    nb_seconds=prefs.bench_seconds)
        return 0

    if not files:
        files = ["-"]

    if mode == "auto":
        mode = ("decompress"
                if files[0].endswith(".lz4") and files[0] != "-"
                else "compress")

    if mode == "test":
        prefs.test_mode = True
        mode = "decompress"

    if mode == "compress" and prefs.max_dist < 65535 and prefs.level >= 2:
        # the cap is honoured by the fast tier only; refuse rather than
        # silently emitting uncapped offsets. Both
        # flags are no-ops on decompression, matching the reference's
        # leniency there.
        raise CliError("--max-dist applies to levels 0/1 only "
                       "(the fast tier); drop the -# level or the cap")

    # console-safety refusals (lz4cli.c:771-828)
    if mode == "compress" and force_stdout is False and files[0] == "-" \
            and sys.stdout.isatty():
        raise CliError("refusing to write compressed data to a console; "
                       "use -c to force")

    if multiple:
        paths = expand_paths(files, recursive)
        rc = 0
        for p in paths:
            try:
                if mode == "compress":
                    compress_file(p, None if not force_stdout else "-",
                                  prefs, backend=backend)
                else:
                    decompress_file(
                        p, None if not force_stdout else "-", prefs,
                        backend=backend)
            except (IoError, OSError, ValueError) as e:
                sys.stderr.write(f"{PROGRAM}: {p}: {e}\n")
                rc = 1
        return rc

    src = files[0]
    dst = files[1] if len(files) > 1 else ("-" if force_stdout else None)
    if src == "-" and dst is None:
        dst = "-"
    try:
        if mode == "compress":
            tin, tout = compress_file(src, dst, prefs, backend=backend)
            if prefs.verbosity >= 2 and dst != "-":
                pct = 100.0 * tout / tin if tin else 0.0
                sys.stderr.write(
                    f"Compressed {tin} bytes into {tout} bytes ==> "
                    f"{pct:.2f}%\n")
        else:
            tin, tout = decompress_file(src, dst, prefs, backend=backend)
            if prefs.verbosity >= 2 and prefs.test_mode:
                sys.stderr.write(f"{src:30s}: decoded {tout} bytes\n")
            elif prefs.verbosity >= 2 and dst != "-":
                sys.stderr.write(f"Decoded {tout} bytes\n")
    except (IoError, OSError, ValueError) as e:
        raise CliError(str(e))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fault-tolerant driver for large-scale path-context extraction (a copy
of ``code2vec_tpu/data/extract_driver.py``; the extractor is the
checkout's own, built with g++ at first use, unless ``--extractor``
names one).

Role of the reference's ``JavaExtractor/extract.py`` / ``CSharpExtractor/
extract.py`` (SURVEY.md §5 'Failure detection'): fan extraction out over
project subdirectories in a worker pool, put a kill-timer on every
extractor subprocess, and on failure/timeout DROP the partial output and
recurse into the failing directory's children to isolate poison files
(reference extract.py:26-41, 49-57). A file that fails on its own is
skipped with a log line instead of sinking its whole project.

Usage:
    python -m code2vec_tpu_torch.data.extract_driver --dir projects/ \
        --output raw.txt [--lang csharp] [--workers 8] [--timeout 600]
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from code2vec_tpu_torch import hostbuild
from code2vec_tpu_torch.serving.extractor_bridge import find_default_extractor

_SOURCE_EXTENSIONS = {'java': '.java', 'csharp': '.cs'}


class ExtractionDriver:
    def __init__(self, extractor_command: List[str], lang: str = 'java',
                 max_path_length: int = 8, max_path_width: int = 2,
                 num_threads: int = 32, timeout_seconds: float = 600.0,
                 log=print):
        self.extractor_command = extractor_command
        self.lang = lang
        self.max_path_length = max_path_length
        self.max_path_width = max_path_width
        self.num_threads = num_threads
        self.timeout_seconds = timeout_seconds
        self.log = log
        self._write_lock = threading.Lock()
        self.nr_failed_files = 0
        self.nr_extracted_dirs = 0

    def _command(self, *target) -> List[str]:
        return self.extractor_command + [
            '--lang', self.lang,
            '--max_path_length', str(self.max_path_length),
            '--max_path_width', str(self.max_path_width),
            '--num_threads', str(self.num_threads), *target]

    def _run(self, *target) -> Optional[str]:
        """One extractor subprocess under a kill-timer; None = failed."""
        try:
            proc = subprocess.run(self._command(*target),
                                  capture_output=True, text=True,
                                  timeout=self.timeout_seconds)
        except subprocess.TimeoutExpired:
            return None
        except OSError as e:  # bad/missing extractor binary
            self.log('Cannot run extractor %r: %s'
                     % (self.extractor_command, e))
            return None
        if proc.returncode != 0:
            return None
        return proc.stdout

    def _count_failed_file(self) -> None:
        with self._write_lock:
            self.nr_failed_files += 1

    def _count_extracted_dir(self) -> None:
        with self._write_lock:
            self.nr_extracted_dirs += 1

    def _extract_dir(self, directory: str, out_file) -> None:
        """Extract one directory; on failure, isolate by recursing
        (reference extract.py:26-41)."""
        output = self._run('--dir', directory)
        if output is not None:
            with self._write_lock:
                out_file.write(output)
            self._count_extracted_dir()
            return
        self.log('Extraction failed/timed out for `%s`; recursing to '
                 'isolate.' % directory)
        extension = _SOURCE_EXTENSIONS[self.lang]
        try:
            entries = sorted(os.scandir(directory), key=lambda e: e.path)
        except OSError as e:
            self.log('Cannot list `%s`: %s' % (directory, e))
            return
        for entry in entries:
            if entry.is_dir(follow_symlinks=False):
                self._extract_dir(entry.path, out_file)
            elif entry.is_file() and entry.name.endswith(extension):
                self._extract_loose_file(entry.path, out_file)

    def extract(self, root_dir: str, out_file, workers: int = 4) -> None:
        """Fan out over top-level subdirectories (the reference pooled over
        project dirs, extract.py:49-57); loose files at the root are one
        extra unit."""
        subdirs = [entry.path for entry in sorted(
            os.scandir(root_dir), key=lambda e: e.path)
            if entry.is_dir(follow_symlinks=False)]
        extension = _SOURCE_EXTENSIONS[self.lang]
        loose_files = [entry.path for entry in os.scandir(root_dir)
                       if entry.is_file()
                       and entry.name.endswith(extension)]
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            futures = [pool.submit(self._extract_dir, d, out_file)
                       for d in subdirs]
            for path in loose_files:
                futures.append(pool.submit(self._extract_loose_file, path,
                                           out_file))
            for future in futures:
                future.result()
        self.log('Done: %d dirs extracted, %d poison files skipped.'
                 % (self.nr_extracted_dirs, self.nr_failed_files))

    def _extract_loose_file(self, path: str, out_file) -> None:
        output = self._run('--file', path)
        if output is None:
            self._count_failed_file()
            self.log('Skipping poison file `%s`.' % path)
        else:
            with self._write_lock:
                out_file.write(output)


def main(argv=None) -> None:
    parser = ArgumentParser(prog='code2vec_tpu_torch.data.extract_driver')
    parser.add_argument('--dir', dest='root_dir', required=True)
    parser.add_argument('--output', dest='output', default='-',
                        help='output file ("-" = stdout)')
    parser.add_argument('--lang', choices=['java', 'csharp'],
                        default='java')
    parser.add_argument('--max_path_length', type=int, default=8)
    parser.add_argument('--max_path_width', type=int, default=2)
    parser.add_argument('--num_threads', type=int, default=32,
                        help='threads per extractor subprocess')
    parser.add_argument('--workers', type=int, default=4,
                        help='concurrent extractor subprocesses')
    parser.add_argument('--timeout', type=float, default=600.0,
                        help='kill-timer per subprocess, seconds')
    parser.add_argument('--extractor', default=None,
                        help='path to the c2v-extract binary')
    args = parser.parse_args(argv)

    try:
        command = [args.extractor] if args.extractor \
            else find_default_extractor()
    except hostbuild.BuildError as exc:
        sys.exit('The extractor did not build (%s); pass --extractor.'
                 % exc)
    driver = ExtractionDriver(
        command, lang=args.lang, max_path_length=args.max_path_length,
        max_path_width=args.max_path_width, num_threads=args.num_threads,
        timeout_seconds=args.timeout,
        log=lambda msg: print(msg, file=sys.stderr))
    if args.output == '-':
        driver.extract(args.root_dir, sys.stdout, workers=args.workers)
    else:
        with open(args.output, 'w') as out_file:
            driver.extract(args.root_dir, out_file, workers=args.workers)


if __name__ == '__main__':
    main()

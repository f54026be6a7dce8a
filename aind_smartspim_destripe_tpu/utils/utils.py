"""
Cross-cutting utilities: logging, resource profiling, environment limits,
filesystem helpers (reference surface: utils/utils.py; see SURVEY.md C14).

The resource profiler here is thread-based (the device pipeline is a single
process — there are no worker forks to observe), sampling process+system CPU
and memory on a cadence and rendering the same two-panel PNG the reference
produces. Device profiling hooks live in runtime/tracing.py.
"""

from __future__ import annotations

import json
import logging
import multiprocessing
import os
import platform
import re
import threading
import time
from datetime import datetime
from pathlib import Path
from typing import List, Optional

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def profile_resources(
    time_points: List,
    cpu_percentages: List,
    memory_usages: List,
    monitoring_interval: int,
):
    """Append (t, cpu%, mem%) samples forever at ``monitoring_interval``
    (reference utils.py:21-61 cadence; run in a daemon thread/process)."""
    start_time = time.time()
    while True:
        time_points.append(time.time() - start_time)
        if psutil is not None:
            cpu_percentages.append(psutil.cpu_percent(interval=monitoring_interval))
            memory_usages.append(psutil.virtual_memory().percent)
        else:  # pragma: no cover
            cpu_percentages.append(0.0)
            memory_usages.append(0.0)
            time.sleep(monitoring_interval)
        time.sleep(monitoring_interval)


class ResourceProfiler:
    """Thread-based sampler with the same output as the reference's
    profiler subprocess (zarr_destriper.py:987-1002 + utils.py:64-121)."""

    def __init__(self, interval: int = 20):
        self.interval = interval
        self.time_points: List[float] = []
        self.cpu: List[float] = []
        self.mem: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def loop():
            t0 = time.time()
            while not self._stop.is_set():
                self.time_points.append(time.time() - t0)
                if psutil is not None:
                    self.cpu.append(psutil.cpu_percent(interval=None))
                    self.mem.append(psutil.virtual_memory().percent)
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def save_graphs(self, output_path: str, prefix: str):
        generate_resources_graphs(
            self.time_points, self.cpu, self.mem, output_path, prefix
        )


def generate_resources_graphs(
    time_points: List,
    cpu_percentages: List,
    memory_usages: List,
    output_path: str,
    prefix: str,
):
    """Two-panel CPU/memory usage PNG (reference utils.py:64-121)."""
    n = min(len(time_points), len(cpu_percentages), len(memory_usages))
    if not n:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6))
    ax1.plot(time_points[:n], cpu_percentages[:n], label="CPU Usage")
    ax1.set_xlabel("Time (s)")
    ax1.set_ylabel("CPU Usage (%)")
    ax1.set_title("CPU Usage Over Time")
    ax1.grid(True)
    ax1.legend()
    ax2.plot(time_points[:n], memory_usages[:n], label="Memory Usage")
    ax2.set_xlabel("Time (s)")
    ax2.set_ylabel("Memory Usage (%)")
    ax2.set_title("Memory Usage Over Time")
    ax2.grid(True)
    ax2.legend()
    fig.tight_layout()
    fig.savefig(f"{output_path}/{prefix}_compute_resources.png", bbox_inches="tight")
    plt.close(fig)


def stop_child_process(process: multiprocessing.Process):
    """Terminate and join a child process (reference utils.py:124-134)."""
    process.terminate()
    process.join()


def create_logger(output_log_path: str) -> logging.Logger:
    """Stream + file logger writing ``destripe_log_{timestamp}.log``
    (reference utils.py:137-172)."""
    stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    logs_file = f"{output_log_path}/destripe_log_{stamp}.log"
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s : %(message)s",
        datefmt="%Y-%m-%d %H:%M",
        handlers=[logging.StreamHandler(), logging.FileHandler(logs_file, "a")],
        force=True,
    )
    logger = logging.getLogger(__name__)
    logger.setLevel(logging.INFO)
    return logger


def get_size(nbytes, suffix: str = "B") -> str:
    """Human-readable byte size (reference utils.py:175-194)."""
    factor = 1024
    for unit in ["", "K", "M", "G", "T", "P"]:
        if nbytes < factor:
            return f"{nbytes:.2f}{unit}{suffix}"
        nbytes /= factor
    return f"{nbytes:.2f}E{suffix}"


def get_code_ocean_cpu_limit():
    """CPU budget: CO_CPUS env, AWS batch -> 1, cgroup quota, else physical
    cores (reference utils.py:197-227)."""
    co_cpus = os.environ.get("CO_CPUS")
    if co_cpus:
        return co_cpus
    if os.environ.get("AWS_BATCH_JOB_ID"):
        return 1
    try:
        with open("/sys/fs/cgroup/cpu/cpu.cfs_quota_us") as fp:
            quota = int(fp.read())
        with open("/sys/fs/cgroup/cpu/cpu.cfs_period_us") as fp:
            period = int(fp.read())
        container_cpus = quota // period
    except FileNotFoundError:
        container_cpus = 0
    if container_cpus >= 1:
        return container_cpus
    if psutil is not None:
        return psutil.cpu_count(logical=False) or os.cpu_count() or 1
    return os.cpu_count() or 1  # pragma: no cover


def print_system_information(logger: logging.Logger):
    """Dump environment / CPU / memory / network details
    (reference utils.py:230-318)."""
    sep = "=" * 40
    logger.info(f"{sep} Environment {sep}")
    logger.info(f"Assigned cores: {get_code_ocean_cpu_limit()}")
    co_memory = os.environ.get("CO_MEMORY")
    if co_memory:
        logger.info(f"Assigned memory: {get_size(int(co_memory))}")
    logger.info(f"Computation ID: {os.environ.get('CO_COMPUTATION_ID')}")
    logger.info(f"Capsule ID: {os.environ.get('CO_CAPSULE_ID')}")
    logger.info(
        f"Is pipeline execution?: {bool(os.environ.get('AWS_BATCH_JOB_ID'))}"
    )
    uname = platform.uname()
    logger.info(f"{sep} System {sep}")
    for field in ("system", "node", "release", "version", "machine", "processor"):
        logger.info(f"{field.capitalize()}: {getattr(uname, field)}")
    if psutil is not None:
        logger.info(f"{sep} CPU / Memory {sep}")
        logger.info(f"Physical cores: {psutil.cpu_count(logical=False)}")
        logger.info(f"Total cores: {psutil.cpu_count(logical=True)}")
        svmem = psutil.virtual_memory()
        logger.info(f"Memory total: {get_size(svmem.total)}")
        logger.info(f"Memory available: {get_size(svmem.available)}")
        logger.info(f"Memory used: {get_size(svmem.used)} ({svmem.percent}%)")
    try:
        import jax

        logger.info(f"{sep} Accelerators {sep}")
        logger.info(f"JAX backend: {jax.default_backend()}")
        logger.info(f"Devices: {jax.devices()}")
    except Exception:  # pragma: no cover
        pass


def read_image_directory_structure(folder_dir, channel_regex: str) -> dict:
    """{channel: {col: {col_row: [images]}}} map of a SmartSPIM file tree
    (reference utils.py:321-380)."""
    def _natkey(name):
        # the reference natsorts every listing (natsort pinned in its
        # Dockerfile); plain sorted() orders non-zero-padded plane names
        # differently ("10.tiff" < "9.tiff") and would shift slide picks
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(name))]

    folder_dir = Path(folder_dir)
    channel_paths = sorted(
        (
            p
            for p in folder_dir.iterdir()
            if p.is_dir() and re.search(channel_regex, str(p.name))
        ),
        key=lambda p: _natkey(p.name),
    )
    if not channel_paths:
        raise ValueError(f"No channels found in path: {folder_dir}")

    cols = sorted(
        (p.name for p in channel_paths[0].iterdir() if p.is_dir()),
        key=_natkey,
    )
    example_col = channel_paths[0] / cols[0]
    rows = sorted(
        (p.name for p in example_col.iterdir() if p.is_dir()), key=_natkey
    )
    images = sorted(
        (p.name for p in (example_col / rows[0]).iterdir()), key=_natkey
    )

    structure: dict = {}
    for channel in channel_paths:
        structure[channel] = {}
        for col in cols:
            if (channel / col).is_dir():
                structure[channel][col] = {}
                for row in rows:
                    if (channel / col / row).is_dir():
                        structure[channel][col][row] = images
    return structure


def create_folder(dest_dir, verbose: Optional[bool] = False) -> None:
    """mkdir -p (reference utils.py:383-411)."""
    if not os.path.exists(dest_dir):
        if verbose:
            print(f"Creating new directory: {dest_dir}")
        os.makedirs(dest_dir, exist_ok=True)


def read_json_as_dict(filepath) -> dict:
    """Read a JSON file; {} when missing; tolerate broken encodings
    (reference utils.py:414-444)."""
    if not os.path.exists(filepath):
        return {}
    try:
        with open(filepath) as f:
            return json.load(f)
    except UnicodeDecodeError:
        with open(filepath, "rb") as f:
            return json.loads(f.read().decode("utf-8", errors="ignore"))

"""Batch system: hierarchical ``task.json`` tasks, pickup/resume, reports.

Port of :mod:`superdsm_tpu.batch` (counterpart of the reference's
``superdsm/batch.py:29-570``), with the JAX package's on-disk contract and
CLI flags: tasks are directories with a ``task.json`` spec inheriting from
their parents (``{DIRNAME}``/``{ROOTDIR}`` placeholders, ``base_config_path``
includes); results are pickled per task (``data.dill.gz``); completion is
tracked by sorted-key MD5 config digests (``.digest``, ``.digest.cfg.json``);
reruns pick up mid-pipeline from the first stage whose configuration
differs; ``timings.csv``/``.timings.json``, ``performance.csv``,
``env.csv``, ``errors.csv``, the ``--shard``/``--merge-shards`` sidecars and
the status file are written as the JAX package writes them.

What differs, because of the card:

- ``data.dill.gz`` is written with the standard library's :mod:`pickle`
  (which ``dill.load`` reads) and holds numpy arrays and the port's objects,
  never a ``torch.Tensor`` (:func:`_dump` refuses one), so a result opens on
  a machine without CUDA;
- the threaded file stream (``SUPERDSM_TPU_TASK_THREADS``, default 3) runs
  each worker on a CUDA stream of its own
  (:func:`superdsm_tpu_torch.parallel.worker_stream`);
- tasks run in forked children as in the JAX package, so the parent process
  never initializes CUDA (a child of a process that has cannot use the
  card): the loader, the digests and the reports stay on the host, the
  device check asks NVML (:func:`superdsm_tpu_torch._device.check_device`),
  and a parent that has touched CUDA already refuses to fork;
- ``--mesh`` (or ``SUPERDSM_TPU_MESH`` in a task's ``environ``) splits
  every solver batch over the mesh's batch axis
  (:func:`superdsm_tpu_torch.parallel.mesh.apply_env_mesh`); a spec that
  needs more devices than the machine has is a parser error;
- ``--debug`` restores the solver telemetry whichever way the task ends.

Without CUDA the CLI raises; on the CPU, select the device and call
:func:`run_cli` in-process::

    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.batch import run_cli
    T.set_device('cpu')
    run_cli([rootdir, '--run', '--no-fork'])

CLI: ``python -m superdsm_tpu_torch.batch <rootpath> --run``.
"""

import csv
import gzip
import json
import os
import pathlib
import pickle
import shutil
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

from ._device import check_device
from .pipeline import create_default_pipeline
from ._aux import mkdir, is_subpath, copy_dict
from .output import get_output, Text
from .io import imread, imsave
from .render import (rasterize_labels, render_ymap, render_atoms,
                     render_adjacencies, render_result_over_image)
from .automation import create_config
from .config import Config
from .globalenergymin import PerformanceReport

DATA_DILL_GZ_FILENAME = 'data.dill.gz'

#: Delimiter conventions of the report CSVs (part of the on-disk contract).
_CSV_STYLE = dict(delimiter=';', quotechar='|', quoting=csv.QUOTE_MINIMAL)


class _HostPickler(pickle.Pickler):
    """Refuses tensors: a result must open where torch has no CUDA."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError('a batch result holds a torch.Tensor; results '
                            'hold host (numpy) data only')
        return NotImplemented


def _dump(obj, path):
    with gzip.open(path, 'wb') as fout:
        _HostPickler(fout, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)


def _load(path):
    with gzip.open(path, 'rb') as fin:
        return pickle.load(fin)


def _write_csv(path, rows):
    with open(str(path), 'w', newline='') as fout:
        csv.writer(fout, **_CSV_STYLE).writerows(rows)


def _format_runtime(seconds):
    hours, rest = divmod(int(round(seconds)), 3600)
    return f'{hours:02}:{rest // 60:02}:{rest % 60:02}'


def _expand(pathpattern, fileid):
    return None if pathpattern is None else str(pathpattern) % fileid


def _process_file(dry, *args, out=None, **kwargs):
    if not dry:
        return __process_file(*args, out=out, **kwargs)
    shown = copy_dict(kwargs)
    if 'cfg' in shown:
        shown['cfg'] = shown['cfg'].entries
    get_output(out).write(f'_process_file: {json.dumps(shown, default=str)}')
    return None, {}


def __process_file(pipeline, data, img_filepath, overlay_filepath, seg_filepath,
                   seg_border, log_filepath, adj_filepath, cfg_filepath, cfg,
                   first_stage, last_stage, rasterize_kwargs, out=None):
    for filepath in (seg_filepath, adj_filepath, log_filepath, cfg_filepath,
                     overlay_filepath):
        if filepath is not None:
            mkdir(pathlib.Path(filepath).parents[0])

    if data is None and first_stage is not None:
        # the pickup task error-skipped this file (its data entry is None,
        # e.g. scale estimation failed there but may succeed on this
        # backend/config): there is nothing to resume from, so process the
        # file from scratch instead of tripping the pipeline's data-required
        # assertion
        first_stage = None

    histological = cfg.get('histological', False)
    imread_kwargs = {}
    if histological:
        imread_kwargs['as_gray'] = False

    g_raw = imread(img_filepath, **imread_kwargs)
    out = get_output(out)

    timings = {}
    if first_stage != '':
        out.intermediate('Creating configuration...')
        t0 = time.time()
        if histological:
            g_gray = g_raw.mean(axis=2)
            g_gray = g_gray.max() - g_gray
        else:
            g_gray = g_raw
        cfg, scale = create_config(pipeline, cfg, g_gray)
        timings['autocfg'] = time.time() - t0
        if cfg_filepath is not None:
            with open(cfg_filepath, 'w') as fout:
                cfg.dump_json(fout)
        if scale is not None:
            out.write(f'Estimated scale: {scale:.2f}')

    def write_adjacencies_image(name, data):
        if adj_filepath is not None:
            ymap = render_ymap(data)
            ymap = render_atoms(data, override_img=ymap, border_color=(0, 0, 0),
                                border_radius=1)
            img = render_adjacencies(data, override_img=ymap, edge_color=(0, 1, 0),
                                     endpoint_color=(0, 1, 0))
            imsave(adj_filepath, img)

    atomic_stage = pipeline.stages[pipeline.find('c2f-region-analysis')]
    atomic_stage.add_callback('end', write_adjacencies_image)
    result_data, _, _timings = pipeline.process_image(
        g_raw, data=data, cfg=cfg, first_stage=first_stage, last_stage=last_stage,
        log_root_dir=log_filepath, out=out)
    atomic_stage.remove_callback('end', write_adjacencies_image)
    timings.update(_timings)

    if overlay_filepath is not None:
        if seg_border is None:
            seg_border = 8
        img_overlay = render_result_over_image(result_data, border_width=seg_border)
        imsave(overlay_filepath, img_overlay)

    if seg_filepath is not None:
        seg_result = rasterize_labels(result_data, **rasterize_kwargs)
        imsave(seg_filepath, seg_result)

    return result_data, timings


def find_first_differing_stage(pipeline, config1, config2):
    """Name of the first pipeline stage whose config entries differ
    (pickup contract, cf. ``superdsm/batch.py:99-109``);
    '' if none differ."""
    assert isinstance(config1, dict) and isinstance(config2, dict)
    names = [stage.name for stage in pipeline.stages]
    if config1.get('AF_scale') != config2.get('AF_scale'):
        return names[0]
    differs = lambda key: config1.get(key, _MISSING) != config2.get(key, _MISSING)
    return next((name for name in names if differs(name)), '')


_MISSING = object()


def _resolve_timings_key(key, candidates):
    """Maps a JSON string key back to the matching (possibly int) file id."""
    matches = [c for c in candidates if str(c) == key]
    if not matches:
        raise ValueError(f'cannot resolve key "{key}"')
    return matches[0]


def _compress_logs(log_dir):
    if log_dir is None or not pathlib.Path(log_dir).is_dir():
        return
    with tarfile.open(f'{log_dir}.tgz', 'w:gz') as tar:
        tar.add(log_dir, arcname=os.path.sep)
    shutil.rmtree(str(log_dir))


def _performance_rows(task_path, data, overall):
    fields = PerformanceReport.attributes + [
        'direct_solution_success', 'iterative_pruning_success',
        'overall_pruning_success', 'nontrivial_pruning_success']
    as_row = lambda tag, perf: [tag] + [getattr(perf, f) for f in fields]
    per_file = [as_row(str(fid), entry['performance'])
                for fid, entry in data.items()
                if entry is not None and 'performance' in entry]
    return [[str(task_path)], ['ID'] + fields] + per_file + [as_row('', overall)]


def _shard_tag(index, count):
    return f'shard-{index}-of-{count}'


def parse_shard(spec):
    """Parses ``"I/N"`` into ``(index, count)`` (0-based index)."""
    index, count = (int(x) for x in str(spec).split('/'))
    if not (count >= 1 and 0 <= index < count):
        raise ValueError(f'invalid shard spec: {spec}')
    return index, count


class Task:
    """A batch processing task (a directory with a ``task.json`` spec).

    :param path: Directory of the task specification.
    :param data: The task specification (JSON data).
    :param parent_task: The parent task, or ``None``.
    """

    #: Standard artifact files of a runnable task (on-disk contract).
    _ARTIFACTS = dict(result_path=DATA_DILL_GZ_FILENAME,
                      timings_path='timings.csv',
                      timings_json_path='.timings.json',
                      performance_path='performance.csv',
                      env_path='env.csv',
                      digest_path='.digest',
                      digest_cfg_path='.digest.cfg.json')

    #: Per-file output path patterns, relative to the task directory.
    _PATHPATTERNS = ('seg', 'adj', 'log', 'cfg', 'overlay')

    #: Scalar task.json knobs: attribute <- (spec key, default).
    _KNOBS = dict(seg_border=('seg_border', None),
                  dilate=('dilate', 0),
                  merge_threshold=('merge_overlap_threshold', np.inf),
                  last_stage=('last_stage', None),
                  environ=('environ', {}))

    def __init__(self, path, data, parent_task=None):
        self.runnable = bool(data.get('runnable', False))
        self.parent_task = parent_task
        self.path = path
        self.data = (Config(data) if parent_task is None
                     else Config(parent_task.data).derive(data))
        root = self
        while root.parent_task is not None:
            root = root.parent_task
        self.rel_path = root.path.parents[0]
        self.file_ids = (sorted(frozenset(self.data.entries['file_ids']))
                         if 'file_ids' in self.data else None)
        self.img_pathpattern = self.data.update(
            'img_pathpattern', lambda p: str(self.resolve_path(p)))
        self._absorb_base_config(data)
        if self.runnable:
            assert self.file_ids is not None
            assert self.img_pathpattern is not None
            self._setup_artifacts()

    def _absorb_base_config(self, data):
        """Folds a ``base_config_path`` include between the parent's config
        and this task's own overrides (task.json inheritance contract)."""
        if 'base_config_path' not in self.data:
            return
        include_path = self.resolve_path(self.data['base_config_path'])
        base_config = json.loads(include_path.read_text())
        parent_config = self.parent_task.data.get('config', Config())
        if isinstance(parent_config, dict):
            parent_config = Config(parent_config)
        self.data['config'] = parent_config.derive(base_config).merge(
            data.get('config', {})).entries
        del self.data.entries['base_config_path']

    def _setup_artifacts(self):
        spec = self.data.entries
        for name in self._PATHPATTERNS:
            raw = spec.get(f'{name}_pathpattern')
            setattr(self, f'{name}_pathpattern',
                    (self.path / raw) if raw is not None else None)
        for attr, filename in self._ARTIFACTS.items():
            setattr(self, attr, self.path / filename)
        for attr, (key, default) in self._KNOBS.items():
            setattr(self, attr, spec.get(key, default))
        config = self.data.get('config', {})
        self.config = config if isinstance(config, Config) else Config(config)

    def resolve_path(self, path):
        if path is None:
            return None
        expanded = (os.path.expanduser(str(path))
                    .replace('{DIRNAME}', self.path.name)
                    .replace('{ROOTDIR}', str(self.root_path)))
        path = pathlib.Path(expanded)
        if path.is_absolute():
            return path.resolve()
        return path.resolve().relative_to(os.getcwd())

    @staticmethod
    def create_from_directory(task_dir, parent_task, override_cfg={},
                              force_runnable=False):
        """Loads a task from a directory containing ``task.json`` (or ``None``)."""
        spec_path = task_dir / 'task.json'
        if not spec_path.exists():
            return None
        try:
            spec = json.loads(spec_path.read_text())
            if force_runnable:
                spec['runnable'] = True
            task = Task(task_dir, spec, parent_task)
            for key, value in override_cfg.items():
                setattr(task, key, value)
        except Exception:
            raise ValueError(f'Error processing: "{spec_path}"')
        return task

    @property
    def root_path(self):
        """The root path of the task tree."""
        return self.path if self.parent_task is None \
            else self.parent_task.root_path

    def _fmt_path(self, path):
        path = pathlib.Path(path)
        return str(path if self.rel_path is None
                   else path.relative_to(self.rel_path))

    def _initialize(self):
        os.environ.update({k: str(v) for k, v in self.environ.items()})
        # multi-device surface: task.json "environ" or the --mesh flag set
        # SUPERDSM_TPU_MESH; solves then split over the mesh batch axis
        from .parallel.mesh import apply_env_mesh
        apply_env_mesh()
        return create_default_pipeline()

    def _load_timings(self):
        if not self.timings_json_path.exists():
            return {}
        stored = json.loads(self.timings_json_path.read_text())
        return {_resolve_timings_key(key, self.file_ids): value
                for key, value in stored.items()}

    @property
    def config_digest(self):
        """MD5 digest of the task's hyperparameters."""
        return self.config.md5.hexdigest()

    def _digest_current(self, digest_path):
        return digest_path.exists() and \
            digest_path.read_text() == self.config_digest

    @property
    def is_pending(self):
        """Whether the task still needs to run (digest mismatch or absent)."""
        return self.runnable and not self._digest_current(self.digest_path)

    # ------------------------------------------------------------------
    # Multi-host dispatch (host-level data parallelism over images).
    #
    # The reference distributes work within one host via Ray's shared-nothing
    # task model (``superdsm/batch.py:258-263``); across
    # hosts, the equivalent here is file striping over a shared
    # filesystem: host i of n runs ``--shard i/n`` (processing
    # ``file_ids[i::n]`` and writing per-shard result/digest sidecars), and
    # any host afterwards runs ``--merge-shards n`` to combine them into the
    # standard task artifacts. No network transport is needed — images are
    # independent, exactly like the reference's Ray tasks.
    # ------------------------------------------------------------------

    def shard_result_path(self, index, count):
        return self.path / f'data.{_shard_tag(index, count)}.dill.gz'

    def shard_digest_path(self, index, count):
        return self.path / f'.digest.{_shard_tag(index, count)}'

    def shard_timings_path(self, index, count):
        return self.path / f'.timings.{_shard_tag(index, count)}.json'

    def is_pending_shard(self, index, count):
        return self.runnable and \
            not self._digest_current(self.shard_digest_path(index, count))

    def merge_shards(self, count, out=None):
        """Combines the ``count`` per-shard results into the standard task
        artifacts (``data.dill.gz``, timings, performance, digest).

        Idempotent: a task whose digest is already current and whose shard
        sidecars are gone (a previous merge consumed them) is skipped, so a
        re-run after a partial multi-task merge picks up where it left off."""
        out = get_output(out)
        sidecars = [i for i in range(count)
                    if self.shard_result_path(i, count).exists()]
        if not sidecars and not self.is_pending:
            out.write(f'Skipping merge (already merged): {self._fmt_path(self.path)}')
            return None
        missing = [i for i in range(count)
                   if not self.shard_result_path(i, count).exists()
                   or self.is_pending_shard(i, count)]
        if missing and not self.is_pending:
            # The task digest is current (a previous merge completed), yet
            # some sidecars exist and some don't. Two legitimate causes, and
            # one resolution handles both: merge the sidecars whose shard
            # digest is CURRENT over the existing data.dill.gz (a leftover
            # from a merge that crashed mid-cleanup re-merges idempotently;
            # a shard the user re-ran with --force after the merge gets
            # incorporated instead of silently discarded), and drop sidecars
            # with a missing/stale shard digest (partial writes).
            merge_ids = [i for i in sidecars if not self.is_pending_shard(i, count)]
            stale = [i for i in sidecars if i not in merge_ids]
            for i in stale:
                self.shard_result_path(i, count).unlink(missing_ok=True)
                self.shard_digest_path(i, count).unlink(missing_ok=True)
                self.shard_timings_path(i, count).unlink(missing_ok=True)
                (self.path / f'errors.{_shard_tag(i, count)}.csv').unlink(
                    missing_ok=True)
            if not merge_ids:
                out.write(f'Skipping merge (already merged; removed '
                          f'{len(stale)} stale sidecar(s)): '
                          f'{self._fmt_path(self.path)}')
                return None
            out.write(f'Re-merging {len(merge_ids)} shard sidecar(s) over the '
                      f'existing result: {self._fmt_path(self.path)}')
        elif missing:
            raise RuntimeError(f'{self._fmt_path(self.path)}: shards not ready '
                               f'(missing or stale: {missing} of {count})')
        else:
            merge_ids = list(range(count))
        # start from the existing task result (if any): shards that skipped
        # writing (e.g. pickup at/after postprocess) contribute empty
        # sidecars, and the unsharded path preserves the old data.dill.gz in
        # that situation — the merge must not replace it with gaps
        data, timings = {}, self._load_timings()
        if self.result_path.exists():
            data = _load(self.result_path)
        for i in merge_ids:
            # a shard sidecar covers exactly its file stripe (or is empty for
            # a run that skipped writing), so its entries replace the stripe
            # VERBATIM — including None for files that error-skipped in a
            # re-run, mirroring the unsharded path (which dumps `data`
            # wholesale); filtering Nones here would resurrect a stale result
            # for a file whose re-run failure is recorded in errors.csv
            data.update(_load(self.shard_result_path(i, count)))
            p = self.shard_timings_path(i, count)
            if p.exists():
                shard_timings = json.loads(p.read_text())
                timings.update({_resolve_timings_key(k, self.file_ids): v
                                for k, v in shard_timings.items()})
        data = {fid: data.get(fid) for fid in self.file_ids}
        performance = PerformanceReport()
        for entry in data.values():
            if entry is not None and 'performance' in entry:
                performance += entry['performance']
        if timings:
            self.write_timings(timings)
        self._write_results(data, performance)
        self._merge_error_sidecars(merge_ids, count)
        for i in merge_ids:
            self.shard_result_path(i, count).unlink()
            self.shard_digest_path(i, count).unlink()
            self.shard_timings_path(i, count).unlink(missing_ok=True)
        out.write(f'Merged {len(merge_ids)} shard(s): '
                  f'{self._fmt_path(self.result_path)}')
        return data

    def _write_results(self, data, performance):
        """Writes the standard task artifacts and marks the digest current."""
        _dump(data, self.result_path)
        with self.digest_cfg_path.open('w') as fout:
            self.config.dump_json(fout)
        _write_csv(self.performance_path,
                   _performance_rows(self.path, data, performance))
        _write_csv(self.env_path, sorted(os.environ.items()))
        self.digest_path.write_text(self.config_digest)

    def _merge_error_sidecars(self, merge_ids, count):
        """Folds per-shard error sidecars into ``errors.csv``: a merged
        shard's rows replace any previous rows for its file stripe."""
        main_path = self.path / 'errors.csv'
        rows = {}
        if main_path.exists():
            with main_path.open('r', newline='') as fin:
                rows = {r[0]: r[1] for r in list(csv.reader(fin))[1:]
                        if len(r) == 2}
        for i in merge_ids:
            stripe = {str(fid) for fid in self.file_ids[i::count]}
            rows = {fid: err for fid, err in rows.items() if fid not in stripe}
            sidecar = self.path / f'errors.{_shard_tag(i, count)}.csv'
            if sidecar.exists():
                with sidecar.open('r', newline='') as fin:
                    rows.update({r[0]: r[1] for r in list(csv.reader(fin))[1:]
                                 if len(r) == 2})
                sidecar.unlink()
        if rows:
            with main_path.open('w', newline='') as fout:
                writer = csv.writer(fout)
                writer.writerow(['file_id', 'error'])
                writer.writerows(sorted(rows.items()))
        else:
            main_path.unlink(missing_ok=True)

    def run(self, task_info=None, dry=False, verbosity=0, force=False, one_shot=False,
            debug=False, report=None, pickup=True, out=None, shard=None):
        out = get_output(out)
        if not self.runnable:
            return
        pending = self.is_pending if shard is None else self.is_pending_shard(*shard)
        if not force and not pending:
            out.write(f'\nSkipping task: {self._fmt_path(self.path)} '
                      f'{"" if task_info is None else f"({task_info})"}')
            return
        info_parts = ([] if task_info is None else [str(task_info)]) \
            + ([] if self.last_stage is None else [f'last stage: {self.last_stage}']) \
            + ([] if shard is None else [f'shard {shard[0] + 1}/{shard[1]}'])
        task_info = ', '.join(info_parts) if info_parts else None
        out.write(Text.style(f'\nEntering task: {self._fmt_path(self.path)} '
                             f'{"" if task_info is None else f"({task_info})"}', Text.BLUE))
        out2 = out.derive(margin=2)
        pipeline = self._initialize()
        assert self.last_stage is None or self.last_stage == '' or \
            not np.isinf(pipeline.find(self.last_stage)), f'unknown stage "{self.last_stage}"'
        # --debug mirrors the reference's serial diagnostics mode
        # (superdsm/batch.py:291): files process serially and the solver
        # prints per-round telemetry from the span recorder, which it turns
        # on, keeping no span. The override covers the whole task and is
        # restored in the finally below, however the task ends: in --no-fork
        # multi-task runs a debug task must not leak telemetry into the tasks
        # after it.
        telemetry_prior = None
        if debug:
            from . import trace as _trace
            from .dsm import batching as _batching
            telemetry_prior = (os.environ.get('SDSM_SOLVE_TELEMETRY'),
                               _batching._TELEMETRY, _trace.enabled())
            os.environ['SDSM_SOLVE_TELEMETRY'] = '1'
            _batching._TELEMETRY = True  # the module reads the env at import
            if not _trace.enabled():
                _trace.enable(True, keep=False)
        try:
            first_stage, data = self.find_first_stage_name(pipeline, dry, pickup, out=out2)
            out3 = out2.derive(margin=2, muted=(verbosity <= -int(not dry)))
            timings = self._load_timings()
            performance = PerformanceReport()
            file_ids = (self.file_ids if shard is None
                        else self.file_ids[shard[0]::shard[1]])

            def _file_kwargs(file_id):
                kwargs = dict(img_filepath=str(self.img_pathpattern) % file_id,
                              seg_filepath=_expand(self.seg_pathpattern, file_id),
                              adj_filepath=_expand(self.adj_pathpattern, file_id),
                              log_filepath=_expand(self.log_pathpattern, file_id),
                              cfg_filepath=_expand(self.cfg_pathpattern, file_id),
                              overlay_filepath=_expand(self.overlay_pathpattern, file_id),
                              rasterize_kwargs=dict(merge_overlap_threshold=self.merge_threshold,
                                                    dilate=self.dilate),
                              seg_border=self.seg_border,
                              last_stage=self.last_stage,
                              cfg=self.config.copy())
                if self.last_stage is not None and \
                        pipeline.find(self.last_stage) < pipeline.find('postprocess'):
                    kwargs['seg_filepath'] = None
                return kwargs

            def _finish_file(file_id, result, _timings):
                data[file_id] = result
                timings.setdefault(file_id, {}).update(_timings)
                if not dry and result is not None and 'performance' in result:
                    nonlocal_performance[0] += result['performance']

            def _process_file_resilient(file_id, *args, **kwargs):
                """Per-file fault isolation: a blob-free image makes scale
                estimation raise (automation.py); the reference kills the
                whole forked task on that (batch.py exits 1). We instead
                record an error row and keep processing the remaining files
                — a deliberate improvement over the reference behavior."""
                try:
                    return _process_file(*args, **kwargs)
                except ValueError as error:
                    if 'scale estimation failed' not in str(error):
                        raise
                    file_errors.append((file_id, str(error)))
                    out3.write(Text.style(
                        f'Error (skipped): {str(self.img_pathpattern) % file_id}'
                        f' — {error}', Text.RED))
                    return None, {}

            file_errors = []
            nonlocal_performance = [performance]
            for file_id in file_ids:
                data.setdefault(file_id, None)

            n_threads = 1 if debug \
                else int(os.environ.get('SUPERDSM_TPU_TASK_THREADS', '3'))
            if not dry and n_threads > 1 and len(file_ids) > 1:
                # host/device-overlapped file stream (superdsm_tpu_torch.
                # parallel.pipelined rationale): image i's host phases
                # (watershed, combinatorics, rendering) run while image j's
                # batched solves occupy the card. Each worker thread uses its
                # own pipeline instance (__process_file mutates stage
                # callbacks) and its own CUDA stream (worker_stream).
                import threading
                from concurrent.futures import ThreadPoolExecutor
                from .parallel.pipelined import worker_stream
                local = threading.local()

                def _worker(file_id):
                    if not hasattr(local, 'pipeline'):
                        local.pipeline = self._initialize()
                    kwargs = _file_kwargs(file_id)
                    # overlapped file processing keeps the card busy — skip
                    # the latency-oriented c2f split-tree speculation (see
                    # superdsm_tpu_torch.parallel.pipelined)
                    kwargs['cfg'].set_default('c2f-region-analysis/speculate', False)
                    with worker_stream():
                        result, _timings = _process_file_resilient(
                            file_id,
                            dry, local.pipeline, data[file_id], first_stage=first_stage,
                            out=out3.derive(muted=True), **kwargs)
                    _compress_logs(_expand(self.log_pathpattern, file_id))
                    return file_id, result, _timings

                done = 0
                with ThreadPoolExecutor(max_workers=n_threads) as pool:
                    for file_id, result, _timings in pool.map(_worker, file_ids):
                        _finish_file(file_id, result, _timings)
                        done += 1
                        if report is not None:
                            report.update(self, done / len(file_ids))
                        out3.write(Text.style(f'[{self._fmt_path(self.path)}] ',
                                              Text.BLUE + Text.BOLD)
                                   + f'Processed file: {str(self.img_pathpattern) % file_id}'
                                   f' ({done} / {len(file_ids)})')
            else:
                for file_idx, file_id in enumerate(file_ids):
                    progress = file_idx / len(file_ids)
                    if report is not None:
                        report.update(self, progress)
                    out3.write(Text.style(f'\n[{self._fmt_path(self.path)}] ',
                                          Text.BLUE + Text.BOLD)
                               + Text.style(f'Processing file: '
                                            f'{str(self.img_pathpattern) % file_id}', Text.BOLD)
                               + f' ({100 * progress:.0f}%)')
                    kwargs = _file_kwargs(file_id)
                    result, _timings = _process_file_resilient(
                        file_id, dry, pipeline, data[file_id],
                        first_stage=first_stage, out=out3, **kwargs)
                    if not dry:
                        _compress_logs(kwargs['log_filepath'])
                    _finish_file(file_id, result, _timings)
            performance = nonlocal_performance[0]
            if not dry:
                # per-shard error sidecars avoid clobbering across hosts;
                # a clean re-run removes a stale errors file
                errors_path = self.path / (
                    'errors.csv' if shard is None
                    else f'errors.{_shard_tag(*shard)}.csv')
                if file_errors:
                    with errors_path.open('w', newline='') as fout:
                        writer = csv.writer(fout)
                        writer.writerow(['file_id', 'error'])
                        writer.writerows(file_errors)
                    out2.write(Text.style(
                        f'{len(file_errors)} file(s) skipped with errors '
                        f'(see {errors_path.name})', Text.RED))
                else:
                    errors_path.unlink(missing_ok=True)
            out2.write('')
            if report is not None:
                report.update(self, 'active')
            if not dry and not np.isnan(performance.nontrivial_pruning_success):
                out2.write(Text.style('Non-trivial pruning: ', Text.BOLD)
                           + f'{100 * performance.nontrivial_pruning_success:.1f}% '
                           f'(computed {performance.nontrivial_computed_object_count} / '
                           f'{performance.nontrivial_object_count})')

            skip_writing_results_conditions = [
                one_shot,
                self.last_stage is not None
                and pipeline.find(self.last_stage) <= pipeline.find('dsm')
                and not self.result_path.exists(),
                first_stage is not None
                and pipeline.find(first_stage) >= pipeline.find('postprocess'),
            ]
            wrote_shard_result = False
            if any(skip_writing_results_conditions):
                out2.write('Skipping writing results')
                # a shard must still complete (digest + sidecar) or it would
                # re-run forever and merge_shards could never proceed; an
                # empty sidecar contributes nothing to the merge — matching
                # the unsharded path, which marks the digest without writing
                # results
                if shard is not None and not dry and not one_shot:
                    _dump({}, self.shard_result_path(*shard))
                    wrote_shard_result = True
            elif shard is not None:
                # shard sidecars only; the standard task artifacts are
                # produced by merge_shards once every shard has finished
                if not dry:
                    result_path = self.shard_result_path(*shard)
                    out2.intermediate(f'Writing results... {self._fmt_path(result_path)}')
                    _dump({fid: data.get(fid) for fid in file_ids}, result_path)
                    with self.shard_timings_path(*shard).open('w') as fout:
                        json.dump({str(k): timings[k] for k in file_ids
                                   if k in timings}, fout)
                    out2.write(Text.style('Results written to: ', Text.BOLD)
                               + self._fmt_path(result_path))
                    wrote_shard_result = True
            else:
                if not dry:
                    self.write_timings(timings)
                    out2.intermediate(f'Writing results... {self._fmt_path(self.result_path)}')
                    self._write_results(data, performance)
                out2.write(Text.style('Results written to: ', Text.BOLD)
                           + self._fmt_path(self.result_path))
            if not dry and not one_shot:
                if shard is not None:
                    # a shard digest without its result sidecar would wedge
                    # merge_shards (fresh digest + missing file): only mark
                    # the shard done when its sidecar was actually written
                    if wrote_shard_result:
                        self.shard_digest_path(*shard).write_text(self.config_digest)
                else:
                    self.digest_path.write_text(self.config_digest)
            return data
        except Exception:
            out.write(Text.style(f'\nError while processing task: {self._fmt_path(self.path)}',
                                 Text.RED))
            raise
        finally:
            if telemetry_prior is not None:
                env, _batching._TELEMETRY, recording = telemetry_prior
                if not recording:
                    _trace.enable(False)
                if env is None:
                    os.environ.pop('SDSM_SOLVE_TELEMETRY', None)
                else:
                    os.environ['SDSM_SOLVE_TELEMETRY'] = env

    def _pickup_candidates(self, pipeline):
        """(task, first differing stage) pairs this task could resume from:
        the nearest runnable ancestor with a result, and its own previous
        result (via the ``.digest.cfg.json`` it was produced under)."""
        candidates = []
        ancestor = self.find_parent_task_with_result()
        if ancestor is not None:
            candidates.append((ancestor, find_first_differing_stage(
                pipeline, self.config.entries, ancestor.config.entries)))
        if self.result_path.exists() and self.digest_cfg_path.exists():
            own_previous = json.loads(self.digest_cfg_path.read_text())
            candidates.append((self, find_first_differing_stage(
                pipeline, self.config.entries, own_previous)))
        return candidates

    def find_runnable_parent_task(self):
        task = self.parent_task
        while task is not None and not task.runnable:
            task = task.parent_task
        return task

    def find_parent_task_with_result(self):
        task = self.find_runnable_parent_task()
        while task is not None and not task.result_path.exists():
            task = task.find_runnable_parent_task()
        return task

    def find_best_pickup_candidate(self, pipeline):
        """The resumable result allowing the latest restart stage."""
        candidates = self._pickup_candidates(pipeline)
        if not candidates:
            return None, None
        return max(candidates, key=lambda c: pipeline.find(c[1]))

    def find_first_stage_name(self, pipeline, dry=False, pickup=True, out=None):
        """Determines the stage to start from (pickup contract; cf.
        ``superdsm/batch.py:393-405``)."""
        out = get_output(out)
        pickup_task, stage_name = (self.find_best_pickup_candidate(pipeline)
                                   if pickup else (None, None))
        if pickup_task is None or pipeline.find(stage_name) <= pipeline.find('dsm') + 1:
            return None, {}
        out.write(f'Picking up from: {self._fmt_path(pickup_task.result_path)} '
                  f'({stage_name if stage_name != "" else "load"})')
        if dry:
            return stage_name, {}
        return stage_name, _load(pickup_task.result_path)

    def write_timings(self, timings):
        stage_names = sorted(next(iter(timings.values())).keys())
        header = [[str(self.path)], ['ID'] + stage_names + ['total']]
        body, totals = [], np.zeros(len(stage_names) + 1)
        for file_id, per_stage in timings.items():
            vals = [per_stage.get(name, 0) for name in stage_names]
            vals.append(sum(vals))
            body.append([file_id] + [_format_runtime(v) for v in vals])
            totals += vals
        footer = [[''] + [_format_runtime(v) for v in totals]]
        _write_csv(self.timings_path, header + body + footer)
        self.timings_json_path.write_text(
            json.dumps({str(k): v for k, v in timings.items()}))


class BatchLoader:
    """Recursively discovers tasks below a root directory."""

    def __init__(self, override_cfg={}):
        self.tasks = []
        self.override_cfg = override_cfg

    def load(self, path):
        """Loads all tasks from the root directory ``path``."""
        self._walk(pathlib.Path(path), None)

    def _walk(self, directory, parent_task):
        task = Task.create_from_directory(directory, parent_task,
                                          self.override_cfg)
        if task is not None:
            self.tasks.append(task)
        for child in sorted(p for p in directory.iterdir() if p.is_dir()):
            self._walk(child, task or parent_task)


def get_path(root_path, path):
    path = pathlib.Path(path)
    return path if path.is_absolute() else pathlib.Path(root_path) / path


class StatusReport:
    """Live status file of the batch queue (pending/active/done/error)."""

    _PREFIX = {'pending': ' o ', 'done': ' ✓ ', 'active': '-> ', 'error': 'EE '}

    def __init__(self, scheduled_tasks, filepath=None):
        self.scheduled_tasks = scheduled_tasks
        self.filepath = filepath
        self.status = dict()
        self.task_progress = None

    def get_task_status(self, task):
        return self.status.get(str(task.path), 'skipped')

    def update(self, task, status, save=True):
        self.task_progress = status if isinstance(status, float) else None
        if self.task_progress is not None:
            status = 'active'
        assert status in self._PREFIX
        if status in ('done', 'active') and self.get_task_status(task) == 'skipped':
            return
        self.status[str(task.path)] = status
        if save:
            self.save()

    def save(self):
        if self.filepath is None:
            return
        lines, skipped = [], []
        for task in self.scheduled_tasks:
            status = self.get_task_status(task)
            if status == 'skipped':
                skipped.append(task)
                continue
            suffix = (f' ({100 * self.task_progress:.0f}%)'
                      if status == 'active' and self.task_progress is not None
                      else '')
            lines.append(f'{self._PREFIX[status]}{task.path}{suffix}')
        if skipped:
            lines += ['', 'Skipped tasks:'] \
                + [f'- {task.path}' for task in skipped]
        with open(str(self.filepath), 'w') as fout:
            fout.write(''.join(line + '\n' for line in lines))


def _build_arg_parser():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('path', help='root directory for batch processing')
    parser.add_argument('--run', help='run batch processing', action='store_true')
    parser.add_argument('--verbosity', help='positive (negative) is more (less) verbose',
                        type=int, default=0)
    parser.add_argument('--force', help='do not skip tasks', action='store_true')
    parser.add_argument('--oneshot', help='do not save results or mark tasks as processed',
                        action='store_true')
    parser.add_argument('--last-stage', help='override the "last_stage" setting',
                        type=str, default=None)
    parser.add_argument('--fresh', help='do not pick up previous results', action='store_true')
    parser.add_argument('--task', help='run only the given task', type=str,
                        default=[], action='append')
    parser.add_argument('--task-dir', help='run only the given task and its sub-directories',
                        type=str, default=[], action='append')
    parser.add_argument('--debug', help='verbose serial diagnostics', action='store_true')
    parser.add_argument('--no-fork', help='run tasks in-process (no per-task fork isolation)',
                        action='store_true')
    parser.add_argument('--report', help='report current status to file', type=str,
                        default=os.path.join(tempfile.gettempdir(), 'superdsm-status'))
    parser.add_argument('--shard', help='process only file stripe I/N of each task '
                        '(host-level data parallelism over a shared filesystem; '
                        'run --merge-shards N afterwards)', type=str, default=None)
    parser.add_argument('--merge-shards', help='merge N per-shard results into the '
                        'standard task artifacts', type=int, default=None)
    parser.add_argument('--mesh', help='split every solver batch over a device '
                        "mesh, e.g. '8', 'batch:4', or 'batch:4,pixel:2' "
                        '(sets SUPERDSM_TPU_MESH)', type=str, default=None)
    return parser


def _selected(task, args):
    """Whether the task matches the --task / --task-dir filters."""
    if not args.task and not args.task_dir:
        return True
    return any(task.path == path for path in args.task) \
        or any(is_subpath(path, task.path) for path in args.task_dir)


def _fork_run(task, run_kwargs, report, out):
    """Runs the task in a forked child (one failing task cannot corrupt the
    parent queue); raises SystemExit on a child failure.

    CUDA does not survive ``fork``: a child of a process that has
    initialized it fails on its first CUDA call. The parent of the batch
    queue stays on the host; one that has initialized CUDA (an in-process
    run before, say) refuses to fork."""
    if torch.cuda.is_initialized():
        raise RuntimeError('this process has initialized CUDA, so a forked '
                           'task could not use the card: run the batch from a '
                           'fresh process or pass --no-fork')
    sys.stdout.flush()
    sys.stderr.flush()
    child = os.fork()
    if child == 0:
        code = 0
        try:
            task.run(**run_kwargs)
        except Exception:
            report.update(task, 'error')
            import traceback
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    if os.waitpid(child, 0)[1] != 0:
        out.write('An error occurred: interrupting')
        sys.exit(1)
    report.update(task, 'done')


def run_cli(args=None):
    parser = _build_arg_parser()
    args = parser.parse_args(args)

    if args.last_stage is not None and not args.oneshot:
        parser.error('Using "--last-stage" only allowed if "--oneshot" is used')
    if args.shard is not None and args.merge_shards is not None:
        parser.error('"--shard" and "--merge-shards" are mutually exclusive')
    shard = parse_shard(args.shard) if args.shard is not None else None
    # every entry point needs the selected device; the check asks NVML, so
    # this process stays free to fork
    check_device()
    if args.mesh is not None:
        # validated eagerly for a clean CLI error (devices counted through
        # NVML); installed per task by Task._initialize (forked children
        # inherit the variable)
        from .parallel.mesh import parse_mesh_spec
        try:
            parse_mesh_spec(args.mesh)
        except (ValueError, RuntimeError) as error:
            parser.error(str(error))
        os.environ['SUPERDSM_TPU_MESH'] = args.mesh

    override_cfg = ({} if args.last_stage is None
                    else {'last_stage': args.last_stage})
    loader = BatchLoader(override_cfg=override_cfg)
    loader.load(args.path)

    args.task = [get_path(args.path, p) for p in args.task]
    args.task_dir = [get_path(args.path, p) for p in args.task_dir]

    dry = not args.run
    out = get_output()
    runnable_tasks = [task for task in loader.tasks if task.runnable]
    out.write(f'Loaded {len(runnable_tasks)} runnable task(s)')
    if dry:
        out.write('DRY RUN: use "--run" to run the tasks instead')

    def pending(task):
        return args.force or (task.is_pending if shard is None
                              else task.is_pending_shard(*shard))

    scheduled_tasks = [t for t in runnable_tasks if _selected(t, args)]
    report = StatusReport(scheduled_tasks, filepath=None if dry else args.report)
    for task in scheduled_tasks:
        if pending(task):
            report.update(task, 'pending', save=False)
    pending_count = sum(pending(t) for t in scheduled_tasks)

    if args.merge_shards is not None:
        for task in scheduled_tasks:
            if dry:
                # dry-run contract: report readiness, touch nothing
                n = args.merge_shards
                ready = [i for i in range(n)
                         if task.shard_result_path(i, n).exists()
                         and not task.is_pending_shard(i, n)]
                merged = len(ready) == 0 and not task.is_pending
                out.write(f'{task._fmt_path(task.path)}: '
                          + ('already merged' if merged
                             else f'{len(ready)} / {n} shard(s) ready to merge'))
            else:
                task.merge_shards(args.merge_shards, out=out)
        return

    run_count = 0
    for task in scheduled_tasks:
        if pending(task):
            run_count += 1
            task_info = f'{run_count} of {pending_count}'
        else:
            task_info = None
        report.update(task, 'active')
        run_kwargs = dict(task_info=task_info, dry=dry, verbosity=args.verbosity,
                          force=args.force, one_shot=args.oneshot,
                          debug=args.debug, report=report,
                          pickup=not args.fresh, out=out, shard=shard)
        if args.no_fork:
            try:
                task.run(**run_kwargs)
                report.update(task, 'done')
            except Exception:
                report.update(task, 'error')
                raise
        else:
            _fork_run(task, run_kwargs, report, out)
    out.write(f'\nRan {run_count} task(s) out of {len(runnable_tasks)} in total')


if __name__ == '__main__':
    run_cli()

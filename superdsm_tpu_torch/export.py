"""Export CLI: re-runs a batch task one-shot and writes rendered PNGs.

Port of :mod:`superdsm_tpu.export` (counterpart of the reference's
``superdsm/export.py:26-131``): the same CLI surface, file layout and mode
registry (``seg``, ``img``, ``fgc``, ``adj``, ``atm``). It needs neither
Pillow nor matplotlib: files go through :mod:`superdsm_tpu_torch.io`, and
the default ``--ymap`` colormap (``seismic``) is one of the colormaps
:mod:`superdsm_tpu_torch.render` carries. Without CUDA it raises; on the
CPU, select the device and call :func:`run_cli` in-process.

CLI: ``python -m superdsm_tpu_torch.export <rootpath> <taskdir> --mode {seg,img,fgc,adj,atm}``.
"""

import pathlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import render as _render
from ._device import check_device
from .batch import Task, _resolve_timings_key
from .output import get_output
from .io import imread, imsave


@dataclass(frozen=True)
class YmapSpec:
    """Intensity mapping for y-map based renderings (``--ymap`` flag,
    ``min:max:gain:cmap``): offsets are clipped to [min, max] and squashed
    through a centered logistic of the given gain."""
    lo: float
    hi: float
    gain: float
    cmap: str

    @classmethod
    def parse(cls, text):
        text = text.lstrip('/')
        lo, hi, gain, cmap = text.split(':')
        return cls(float(lo), float(hi), float(gain), cmap)

    def squash(self, y):
        z = np.exp(self.gain * np.clip(y, self.lo, self.hi))
        return z / (1 + z) - 0.5

    def render(self, y):
        clim = tuple(self.squash(np.array([self.lo, self.hi])))
        return _render.render_ymap(self.squash(y), clim=clim,
                                   cmap=self.cmap)[:, :, :3]

    def legend(self):
        row = self.render(np.linspace(self.lo, self.hi, 200)[None, :])
        return np.vstack([row] * 10)


@dataclass(frozen=True)
class ExportMode:
    """One export mode: where it writes, how far the pipeline runs, and how
    a processed image is rendered."""
    name: str
    outdir: str
    border: Optional[int]
    last_stage: Optional[str]
    needs_ymap: bool
    render: Callable  # (data, border, ymap_spec, enhance) -> image


def _render_seg(data, border, ymap, enhance, border_position='center'):
    return _render.render_result_over_image(
        data, border_width=border, border_position=border_position,
        normalize_img=enhance)


def _render_fgc(data, border, ymap, enhance):
    return _render.render_foreground_clusters(
        data, override_img=ymap.render(data['y']), border_color=(0, 0, 0),
        border_radius=border // 2)


def _render_adj(data, border, ymap, enhance):
    base = _render.render_atoms(data, override_img=ymap.render(data['y']),
                                border_color=(0, 0, 0),
                                border_radius=border // 2)
    return _render.render_adjacencies(data, override_img=base,
                                      edge_color=(0, 1, 0),
                                      endpoint_color=(0, 1, 0))


def _render_atm(data, border, ymap, enhance):
    return _render.render_atoms(data, border_color=(0, 1, 0),
                                border_radius=border // 2,
                                normalize_img=enhance)


MODES = {m.name: m for m in [
    ExportMode('seg', 'export-seg', 8, None, False, _render_seg),
    ExportMode('img', 'export-img', None, None, False, None),
    ExportMode('fgc', 'export-fgc', 2, 'c2f-region-analysis', True, _render_fgc),
    ExportMode('adj', 'export-adj', 2, 'c2f-region-analysis', True, _render_adj),
    ExportMode('atm', 'export-atm', 6, 'c2f-region-analysis', False, _render_atm),
]}


def load_task_chain(rootpath, taskdir):
    """Loads the task at ``taskdir`` with the inherited configuration of its
    ancestors under ``rootpath`` (the task.json tree), forcing it runnable."""
    rootpath = pathlib.Path(rootpath)
    taskdir = pathlib.Path(taskdir)
    if not taskdir.is_absolute():
        taskdir = rootpath / taskdir
    if not rootpath.exists():
        raise ValueError(f'Root path does not exist: {rootpath}')
    if not taskdir.is_dir():
        raise ValueError(f'Task directory does not exist: {taskdir}')

    lineage = [taskdir]
    while lineage[-1] != rootpath:
        parent = lineage[-1].parent
        if parent == lineage[-1]:  # reached the filesystem root
            raise ValueError(f'Task directory is not under the root path: '
                             f'{taskdir} vs {rootpath}')
        lineage.append(parent)
    tasks = []
    for directory in reversed(lineage):
        task = Task.create_from_directory(directory, tasks[-1] if tasks else None)
        if task is not None:
            tasks.append(task)
    task = tasks[-1]
    if not task.runnable:
        task = Task.create_from_directory(
            task.path, tasks[-2] if len(tasks) > 1 else None,
            force_runnable=True)
    return task


def _prepare_task_for_export(task, image_ids, last_stage):
    """Disables all batch side outputs; the export writes its own files."""
    if image_ids:
        task.file_ids = [_resolve_timings_key(fid, task.file_ids)
                         for fid in image_ids]
    for attr in ('seg_pathpattern', 'log_pathpattern', 'adj_pathpattern',
                 'overlay_pathpattern'):
        setattr(task, attr, None)
    task._load_timings = lambda *a: {}
    if last_stage is not None:
        task.last_stage = last_stage
    return task


def export_images(task, outdir, out, enhance=False):
    """Mode 'img': copies (optionally contrast-enhanced) raw images."""
    for image_id in task.file_ids:
        src = str(task.img_pathpattern) % image_id
        dst = outdir / f'{image_id}.png'
        out.intermediate(f'Processing image... {dst}')
        img = imread(src)
        if enhance:
            img = _render.normalize_image(img)
        dst.parent.mkdir(parents=True, exist_ok=True)
        imsave(str(dst), img)


def run_cli(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description='Re-runs a batch task and exports renderings.')
    parser.add_argument('rootpath', help='root directory for batch processing')
    parser.add_argument('taskdir', help='batch task directory path')
    parser.add_argument('--outdir', default=None, help='output directory')
    parser.add_argument('--imageid', default=[], action='append',
                        help='only export this image ID (repeatable)')
    parser.add_argument('--border', type=int, default=None, help='border width')
    parser.add_argument('--border-position', default='center',
                        choices=('inner', 'center', 'outer'))
    parser.add_argument('--enhance', action='store_true',
                        help='apply contrast enhancement')
    parser.add_argument('--mode', default='seg', choices=sorted(MODES))
    parser.add_argument('--ymap', default='-0.8:+1:5:seismic',
                        help='intensity mapping min:max:gain:cmap for y-map '
                             'based renderings')
    args = parser.parse_args(argv)
    check_device()

    mode = MODES[args.mode]
    border = args.border if args.border is not None else mode.border
    ymap = YmapSpec.parse(args.ymap) if mode.needs_ymap else None

    task = load_task_chain(args.rootpath, args.taskdir)
    outdir = pathlib.Path(args.outdir if args.outdir is not None else mode.outdir)
    if not outdir.is_absolute():
        outdir = task.path / outdir
    outdir.mkdir(parents=True, exist_ok=True)

    out = get_output(None)
    _prepare_task_for_export(task, args.imageid, mode.last_stage)

    if mode.name == 'img':
        export_images(task, outdir, out, enhance=args.enhance)
        out.write(f'Exported {len(task.file_ids)} files')
        return

    if ymap is not None:
        legend_file = outdir / 'ymap_legend.png'
        out.write(f'\nWriting legend: {legend_file}')
        imsave(str(legend_file), ymap.legend())

    data = task.run(one_shot=True, force=True, out=out)
    out.write('\nRunning export:')
    for image_id in task.file_ids:
        dst = outdir / f'{image_id}.png'
        out.intermediate(f'  Processing image... {dst}')
        dst.parent.mkdir(parents=True, exist_ok=True)
        if mode.name == 'seg':
            img = _render_seg(data[image_id], border, ymap, args.enhance,
                              border_position=args.border_position)
        else:
            img = mode.render(data[image_id], border, ymap, args.enhance)
        imsave(str(dst), img)
        out.write(f'  Exported {dst}')
    out.write(f'\nExported {len(task.file_ids)} files')


if __name__ == '__main__':
    run_cli()

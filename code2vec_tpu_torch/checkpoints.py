"""Save, restore and release — the counterpart of
``code2vec_tpu/checkpoints.py``'s ``CheckpointStore``, with its on-disk
names:

    <path>__entire-model/<step>/   the full state: params, Adam, step, epoch
    <path>__step-snapshots/<step>/ the same, saved every SAVE_EVERY_N_STEPS
    <path>__only-weights/          the release: params only
    <path>.meta.json               the settings that fix the shapes
    dictionaries.bin               the vocabularies, beside <path> (vocab.py)

The port writes each artifact as one ``torch.save`` file
(``checkpoint.pt``) of host tensors in a plain dict, read back with
``torch.load(weights_only=True)``:

    {'params': {name: fp32},
     'opt_state': {'count': int, 'mu': {name}, 'nu': {name}},   # stored dtypes
     'step': int, 'epoch': int}                                  # entire model

Under LAZY_EMBEDDING_ADAM the optimizer state is the reference's
``LazyAdamState`` under its field names: ``{'dense': {'count', 'mu',
'nu'} over the target table, transform and attention, 'mu': {table},
'nu': {table}}`` over the token and path tables.

The names are the ``Code2VecParams`` fields, the layout the reference
calls canonical. An artifact is written under a temporary name and
committed by ``os.replace``; restores see committed step directories only
(digit names). MAX_TO_KEEP epoch saves are kept, and 2 step snapshots in
their own directory, so frequent snapshots never evict the epoch history.
A restore takes the newest step across both; a step that fails to read
(a truncated write) is skipped for the next older one and, once an older
one restores, moved aside to ``<step>.corrupt``. The divergence guard's
rewind restores under a ceiling (``restore_training(max_step=)``) and
moves every newer step aside to ``<step>.rewound``.

The reference's own artifacts (orbax OCDBT/zarr trees) are read without
JAX through ``tensorstore`` (``read_orbax_checkpoint``): the format is
told per artifact, so a store the reference wrote loads for evaluation
and for training resume alike (the Adam trees map one to one).

On restore the target table's padded rows follow the current allocation
(``target_vocab_rows``): the rows past the vocabulary are masked padding
with zero gradient and zero moments, so they are padded with zeros or
sliced off, in params and moments. Moments come back in their stored
dtypes; the trainer casts them to the configured ones
(``Trainer.state_from_restored``).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.resilience import faults

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = 'checkpoint.pt'
ORBAX_METADATA = '_METADATA'
# stamped into every meta file by both packages: the flat {name: array}
# params layout
LAYOUT = 'canonical-v1'
TARGET_ROWS_KEY = 'target_vocab_rows'
# retained step snapshots (SAVE_EVERY_N_STEPS): the newest and one before
# it, the fallback when the newest does not read
SNAPSHOTS_TO_KEEP = 2
TARGET_LEAF_NAME = 'target_embedding'
# metadata keys whose mismatch does not refuse a restore: 'framework' is
# informational (its first writer's value stays on a re-save), and target
# rows are adapted
NON_STRICT_KEYS = frozenset({'framework', TARGET_ROWS_KEY})


class RestoredTraining(NamedTuple):
    params: Dict[str, torch.Tensor]
    # {'count': int, 'mu': {name}, 'nu': {name}}, or lazy Adam's layout
    opt_state: Dict[str, Any]
    step: int
    epoch: int


def read_orbax_checkpoint(directory: str) -> dict:
    """An orbax tree written by ``code2vec_tpu`` (a step's ``default/``
    item, or the release directory) as numpy arrays:
    ``{'params': {name: array}, 'opt_state': {'count', 'mu': {name},
    'nu': {name}}, 'step', 'epoch'}``, whichever of these it holds. The
    keys come from ``_METADATA``'s ``tree_metadata``; each array is read
    through ``tensorstore``'s zarr driver over the OCDBT store. optax's
    ``(ScaleByAdamState, EmptyState)`` tuple becomes its Adam state; a
    ``LazyAdamState`` keeps its fields, its ``dense`` optax tuple
    becoming the Adam state of the dense keys."""
    try:
        import tensorstore
    except ImportError as exc:
        raise ImportError(
            'reading a checkpoint written by code2vec_tpu (orbax, at `%s`) '
            'needs the tensorstore package, which is not installed'
            % directory) from exc
    if not os.path.isfile(os.path.join(directory, 'manifest.ocdbt')):
        raise ValueError('`%s` is not an OCDBT orbax checkpoint' % directory)
    with open(os.path.join(directory, ORBAX_METADATA)) as f:
        tree_metadata = json.load(f)['tree_metadata']
    base = 'file://' + os.path.abspath(directory) + '/'
    out: dict = {}
    for entry in tree_metadata.values():
        if entry['value_metadata'].get('skip_deserialize'):
            continue       # a None leaf: optax's EmptyState
        keys = [str(part['key']) for part in entry['key_metadata']]
        spec = {'driver': 'zarr',
                'kvstore': {'driver': 'ocdbt', 'base': base},
                'path': '.'.join(keys)}
        array = tensorstore.open(spec).result().read().result()
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(array)
    if 'opt_state' in out:
        opt_state = out['opt_state']
        if 'dense' in opt_state:
            opt_state = dict(opt_state, dense=opt_state['dense']['0'])
        else:
            opt_state = opt_state['0']
        out['opt_state'] = opt_state
    return out


def _tensor(array: np.ndarray) -> torch.Tensor:
    """numpy -> torch in the same dtype; bf16 (ml_dtypes) through fp32,
    exactly."""
    if array.dtype.name == 'bfloat16':
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def _from_orbax(tree: dict) -> dict:
    """``read_orbax_checkpoint``'s tree in the port's payload layout."""
    payload: Dict[str, Any] = {
        'params': {name: _tensor(a) for name, a in tree['params'].items()}}
    if 'opt_state' in tree:
        payload['opt_state'] = map_opt_state(
            tree['opt_state'],
            lambda named: {name: _tensor(a) for name, a in named.items()})
    for key in ('step', 'epoch'):
        if key in tree:
            payload[key] = int(tree[key])
    return payload


def read_artifact(directory: str) -> dict:
    """One artifact (a step directory or the release directory) in the
    port's payload layout, whichever package wrote it."""
    path = os.path.join(directory, CHECKPOINT_FILE)
    if os.path.isfile(path):
        return torch.load(path, map_location='cpu', weights_only=True,
                          mmap=True)
    for item in (os.path.join(directory, 'default'), directory):
        if os.path.isfile(os.path.join(item, ORBAX_METADATA)):
            return _from_orbax(read_orbax_checkpoint(item))
    raise ValueError('No checkpoint in `%s`.' % directory)


def _resize_rows(tensor: torch.Tensor, rows: int) -> torch.Tensor:
    """Pad with zero rows or slice to ``rows`` (the masked padding rows of
    the target table)."""
    if tensor.shape[0] >= rows:
        return tensor[:rows]
    pad = tensor.new_zeros((rows - tensor.shape[0],) + tuple(tensor.shape[1:]))
    return torch.cat([tensor, pad])


def _commit(directory: str, payload: dict) -> None:
    """Write ``payload`` to ``directory/checkpoint.pt`` under a temporary
    directory, then move it into place (replacing an older one)."""
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    suffix = '.tmp-%d' % os.getpid()
    tmp = directory + suffix
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
    old = None
    if os.path.exists(directory):
        old = directory + '.old' + suffix
        os.replace(directory, old)
    os.replace(tmp, directory)
    if old is not None:
        shutil.rmtree(old)


def _committed_steps(directory: str) -> List[int]:
    """The committed step directories under ``directory``, oldest first
    (a save in flight or a quarantined step has a non-digit name)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(name) for name in names if name.isdigit())


def _host(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {name: t.detach().cpu() for name, t in named.items()}


def map_opt_state(opt_state: Dict[str, Any], fn) -> Dict[str, Any]:
    """``opt_state`` (Adam's or lazy Adam's layout) with ``fn`` applied
    to each {name: tensor} moment dict; ``count`` an int."""
    out: Dict[str, Any] = {}
    for key, value in opt_state.items():
        if key == 'count':
            out[key] = int(value)
        elif key == 'dense':
            out[key] = map_opt_state(value, fn)
        else:
            out[key] = fn(value)
    return out


class CheckpointStore:
    """The checkpoints of one model path prefix."""

    def __init__(self, model_path: str, max_to_keep: int = 10,
                 metadata: Optional[Dict[str, Any]] = None):
        self.model_path = model_path
        self.entire_dir = os.path.abspath(
            Config.get_entire_model_path(model_path))
        self.weights_dir = os.path.abspath(
            Config.get_model_weights_path(model_path))
        self.snapshot_dir = os.path.abspath(
            Config.get_step_snapshots_path(model_path))
        self.meta_path = os.path.abspath(model_path) + '.meta.json'
        self.max_to_keep = max_to_keep
        # the settings that fix the shapes: written at save, verified
        # before restore
        self.metadata = metadata or {}

    # ------------------------------------------------------------ metadata
    def _stored_metadata(self) -> Dict[str, Any]:
        if not os.path.isfile(self.meta_path):
            return {}
        with open(self.meta_path) as f:
            return json.load(f)

    def _write_metadata(self) -> None:
        if not self.metadata:
            return
        to_write = dict(self.metadata, checkpoint_layout=LAYOUT)
        stored = self._stored_metadata()
        if 'framework' in stored:
            to_write['framework'] = stored['framework']
        with open(self.meta_path, 'w') as f:
            json.dump(to_write, f)

    def verify_metadata(self) -> None:
        """Refuse a restore whose stored shape settings differ from the
        current ones, naming the key."""
        stored = self._stored_metadata()
        if not stored or not self.metadata:
            return
        if stored.get('checkpoint_layout') != LAYOUT:
            raise ValueError(
                'Checkpoint at `%s` predates the canonical parameter layout '
                '(checkpoint_layout=%r).' % (self.model_path,
                                             stored.get('checkpoint_layout')))
        for key, value in self.metadata.items():
            if key in NON_STRICT_KEYS:
                continue
            if key in stored and stored[key] != value:
                raise ValueError(
                    'Checkpoint at `%s` was saved with %s=%r but the current '
                    'config has %s=%r; these settings determine parameter '
                    'shapes and must match.' % (self.model_path, key,
                                                stored[key], key, value))

    # ---------------------------------------------------------------- save
    def save_training(self, *, params: Dict[str, torch.Tensor],
                      opt_state: Dict[str, Any], step: int,
                      epoch: int, snapshot: bool = False) -> None:
        """The full state at ``step`` (``epoch``: the last completed
        epoch), then the retention of MAX_TO_KEEP steps; ``snapshot``
        saves into the step-snapshot directory, which keeps
        SNAPSHOTS_TO_KEEP."""
        payload = {'params': _host(params),
                   'opt_state': map_opt_state(opt_state, _host),
                   'step': int(step), 'epoch': int(epoch)}
        directory = self.snapshot_dir if snapshot else self.entire_dir
        keep = SNAPSHOTS_TO_KEEP if snapshot else self.max_to_keep
        _commit(os.path.join(directory, str(int(step))), payload)
        for old in _committed_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, str(old)))
        if snapshot and faults.maybe_fire('corrupt_snapshot'):
            # the fault drill: the on-disk state a full disk or a killed
            # writer leaves, which a restore must fall back past
            faults.corrupt_directory(os.path.join(directory,
                                                  str(int(step))))
        self._write_metadata()

    def save_release(self, params: Dict[str, torch.Tensor]) -> None:
        """The params-only artifact (the reference's ``--release``)."""
        _commit(self.weights_dir, {'params': _host(params)})
        self._write_metadata()

    # ------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """Committed epoch-save steps, oldest first (a save in flight has
        a non-digit name)."""
        return _committed_steps(self.entire_dir)

    def _candidates(self) -> List[Tuple[str, int]]:
        """Every committed ``(directory, step)`` of the epoch saves and
        the step snapshots, newest step first (the epoch save first on a
        tie)."""
        candidates = [(directory, step)
                      for directory in (self.entire_dir, self.snapshot_dir)
                      for step in _committed_steps(directory)]
        return sorted(candidates, key=lambda c: c[1], reverse=True)

    def has_step(self, step: int) -> bool:
        """A committed checkpoint of ``step`` in either directory."""
        return any(s == step for _d, s in self._candidates())

    def _quarantine(self, directory: str, step: int,
                    suffix: str = '.corrupt') -> None:
        """Move ``directory/<step>`` aside to ``<step><suffix>`` (a
        numbered destination when that exists: a repeat rewind may purge
        a step number again), out of retention's and restore's way.
        Renaming it back undoes it."""
        step_dir = os.path.join(directory, str(step))
        try:
            if os.path.isdir(step_dir):
                dest = step_dir + suffix
                serial = 1
                while os.path.exists(dest):
                    serial += 1
                    dest = '%s%s.%d' % (step_dir, suffix, serial)
                os.replace(step_dir, dest)
                logger.warning('checkpoint %s: quarantined step %d to `%s`',
                               self.model_path, step, dest)
        except OSError as exc:
            logger.warning('checkpoint %s: could not quarantine step %d '
                           '(%s)', self.model_path, step, exc)

    def purge_steps_newer_than(self, step: int) -> None:
        """Move every committed step newer than ``step`` aside, in both
        directories (suffix ``.rewound``): after a rewind they hold
        weights from the poisoned window, and a resume must not take them
        for the newest state."""
        for directory, retained in self._candidates():
            if retained > step:
                self._quarantine(directory, retained, suffix='.rewound')

    def _restore_with_fallback(self, candidates, attempt, what: str):
        """``attempt(directory, step)`` newest first. A failed step is
        skipped for the next older one and quarantined once one restores;
        when every candidate fails nothing is moved (a failure they all
        share is a setting, not a corrupt file) and the newest failure is
        raised. A missing reader (ImportError) fails at once."""
        failed = []
        for directory, step in candidates:
            try:
                restored = attempt(directory, step)
            except ImportError:
                raise
            except Exception as exc:
                logger.warning(
                    'checkpoint %s: %s of step %d failed (%r); falling '
                    'back to the next older retained step',
                    self.model_path, what, step, exc)
                failed.append((directory, step, exc))
                continue
            for failed_dir, failed_step, _exc in failed:
                self._quarantine(failed_dir, failed_step)
            return restored
        last_exc = failed[-1][2]
        raise ValueError(
            'No retained checkpoint under `%s` could be restored (all %d '
            'candidate step(s) failed, so nothing was quarantined — '
            'suspect a config or environment cause); newest failure: %r'
            % (self.model_path, len(candidates), last_exc)) from last_exc

    def _adapt_rows(self, named: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        rows = self.metadata.get(TARGET_ROWS_KEY)
        tensor = named.get(TARGET_LEAF_NAME)
        if rows is None or tensor is None or tensor.shape[0] == rows:
            return named
        return dict(named, **{TARGET_LEAF_NAME: _resize_rows(tensor, rows)})

    def _restore_training_at(self, directory: str, step: int
                             ) -> RestoredTraining:
        payload = read_artifact(os.path.join(directory, str(step)))
        return RestoredTraining(
            params=self._adapt_rows(payload['params']),
            opt_state=map_opt_state(payload['opt_state'],
                                     self._adapt_rows),
            step=int(payload['step']), epoch=int(payload['epoch']))

    def _restore_params_at(self, directory: str, step: int
                           ) -> Dict[str, torch.Tensor]:
        return self._adapt_rows(read_artifact(os.path.join(
            directory, str(step)))['params'])

    def restore_training(self, max_step: Optional[int] = None
                         ) -> Optional[RestoredTraining]:
        """The newest full state that restores, across the epoch saves
        and the step snapshots, no newer than ``max_step`` (the divergence
        guard's last known-finite step); None when there is none."""
        candidates = [c for c in self._candidates()
                      if max_step is None or c[1] <= max_step]
        if not candidates:
            return None
        self.verify_metadata()
        return self._restore_with_fallback(
            candidates, self._restore_training_at, 'restore')

    def newest_step(self) -> Optional[int]:
        """The newest committed step across both directories, or None
        when there is none."""
        candidates = self._candidates()
        return candidates[0][1] if candidates else None

    def restore_params_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Params only, of the retained step ``step`` (the serving
        engine's rollover to a step): a step that is not retained raises,
        there is no fallback to another step."""
        self.verify_metadata()
        candidates = [c for c in self._candidates() if c[1] == step]
        if not candidates:
            raise ValueError(
                'No retained checkpoint at step %d under `%s` (retained: '
                '%s)' % (step, self.model_path,
                         sorted({s for _d, s in self._candidates()})))
        return self._restore_with_fallback(
            candidates, self._restore_params_at,
            'params restore at step %d' % step)

    def restore_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """Params only: the release when there is one, else the newest
        full state that restores; None when there is neither."""
        self.verify_metadata()
        if os.path.isdir(self.weights_dir):
            return self._adapt_rows(read_artifact(self.weights_dir)['params'])
        candidates = self._candidates()
        if not candidates:
            return None
        return self._restore_with_fallback(
            candidates, self._restore_params_at, 'params-only restore')

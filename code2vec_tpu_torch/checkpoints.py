"""Save, restore and release — the counterpart of
``code2vec_tpu/checkpoints.py``'s ``CheckpointStore``, with its on-disk
names:

    <path>__entire-model/<step>/   the full state: params, Adam, step, epoch
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
(digit names), and MAX_TO_KEEP of them are kept.

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
import os
import shutil
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from code2vec_tpu_torch.config import Config

CHECKPOINT_FILE = 'checkpoint.pt'
ORBAX_METADATA = '_METADATA'
# stamped into every meta file by both packages: the flat {name: array}
# params layout
LAYOUT = 'canonical-v1'
TARGET_ROWS_KEY = 'target_vocab_rows'
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
                      epoch: int) -> None:
        """The full state at ``step`` (``epoch``: the last completed
        epoch), then the retention of MAX_TO_KEEP steps."""
        payload = {'params': _host(params),
                   'opt_state': map_opt_state(opt_state, _host),
                   'step': int(step), 'epoch': int(epoch)}
        _commit(os.path.join(self.entire_dir, str(int(step))), payload)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.entire_dir, str(old)))
        self._write_metadata()

    def save_release(self, params: Dict[str, torch.Tensor]) -> None:
        """The params-only artifact (the reference's ``--release``)."""
        _commit(self.weights_dir, {'params': _host(params)})
        self._write_metadata()

    # ------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        """Committed steps, oldest first (a save in flight has a
        non-digit name)."""
        try:
            names = os.listdir(self.entire_dir)
        except OSError:
            return []
        return sorted(int(name) for name in names if name.isdigit())

    def _adapt_rows(self, named: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        rows = self.metadata.get(TARGET_ROWS_KEY)
        tensor = named.get(TARGET_LEAF_NAME)
        if rows is None or tensor is None or tensor.shape[0] == rows:
            return named
        return dict(named, **{TARGET_LEAF_NAME: _resize_rows(tensor, rows)})

    def restore_training(self) -> Optional[RestoredTraining]:
        """The newest full state, or None when there is none."""
        steps = self.steps()
        if not steps:
            return None
        self.verify_metadata()
        payload = read_artifact(os.path.join(self.entire_dir,
                                             str(steps[-1])))
        return RestoredTraining(
            params=self._adapt_rows(payload['params']),
            opt_state=map_opt_state(payload['opt_state'],
                                     self._adapt_rows),
            step=int(payload['step']), epoch=int(payload['epoch']))

    def newest_step(self) -> Optional[int]:
        """The newest committed step, or None when there is none."""
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_params_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Params only, of the retained step ``step`` (the serving
        engine's rollover to a step): a step that is not retained raises,
        there is no fallback to another."""
        self.verify_metadata()
        if step not in self.steps():
            raise ValueError(
                'No retained checkpoint at step %d under `%s` (retained: '
                '%s)' % (step, self.model_path, self.steps()))
        return self._adapt_rows(read_artifact(os.path.join(
            self.entire_dir, str(step)))['params'])

    def restore_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """Params only: the release when there is one, else the newest
        full state; None when there is neither."""
        self.verify_metadata()
        if os.path.isdir(self.weights_dir):
            directory = self.weights_dir
        else:
            steps = self.steps()
            if not steps:
                return None
            directory = os.path.join(self.entire_dir, str(steps[-1]))
        return self._adapt_rows(read_artifact(directory)['params'])

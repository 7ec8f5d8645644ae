"""Hyperparameter configuration trees.

API-compatible re-design of the reference's ``superdsm/config.py`` (see
``superdsm/config.py:9-188``): nested dictionaries addressed
with ``/``-separated keys, merging, deep copies, JSON dumps, and an MD5 digest
used by the batch system to decide whether a task is up to date.
"""

import json
import hashlib


def _cleanup_value(value):
    return value.entries if isinstance(value, Config) else value


class Config:
    """A set of hyperparameters, organized as a nested mapping.

    Keys may be ``/``-namespaced, e.g. ``cfg['dsm/alpha'] = 0.5`` writes the
    ``alpha`` entry of the ``dsm`` sub-configuration.

    Wrapping a ``dict`` does not copy it; passing another :class:`Config`
    creates a deep copy.
    """

    def __init__(self, other=None):
        if other is None:
            other = dict()
        if isinstance(other, dict):
            self.entries = other
        elif isinstance(other, Config):
            self.entries = json.loads(json.dumps(other.entries))
        else:
            raise ValueError(f'Unknown argument: {other}')

    def _resolve(self, key, create=True):
        """Walks to the parent config of a ``/``-namespaced key."""
        keys = key.split('/')
        config = self
        for k in keys[:-1]:
            config = config.get(k, {}) if create else config[k]
        return config, keys[-1]

    def pop(self, key, default):
        """Removes hyperparameter ``key``, returning its value or ``default``."""
        if '/' in key:
            config, key = self._resolve(key)
            return config.pop(key, default)
        return self.entries.pop(key, default)

    def set_default(self, key, default, override_none=False):
        """Sets ``key`` to ``default`` unless already set; returns the value.

        :param override_none: treat an entry holding ``None`` as unset.
        """
        if '/' in key:
            keys = key.split('/')
            config = self
            for k in keys[:-1]:
                config = config.set_default(k, {}, override_none)
            return config.set_default(keys[-1], default, override_none)
        if key not in self.entries or (override_none and self.entries[key] is None):
            self.entries[key] = _cleanup_value(default)
        return self[key]

    def get(self, key, default):
        """Returns the value of ``key``, materializing ``default`` if unset."""
        if '/' in key:
            config, key = self._resolve(key)
            return config.get(key, default)
        if key not in self.entries:
            self.entries[key] = _cleanup_value(default)
        value = self.entries[key]
        return Config(value) if isinstance(value, dict) else value

    def __getitem__(self, key):
        if '/' in key:
            config, key = self._resolve(key, create=False)
            return config[key]
        value = self.entries[key]
        return Config(value) if isinstance(value, dict) else value

    def __contains__(self, key):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def update(self, key, func):
        """Maps the value of ``key`` through ``func`` (missing → ``None``)."""
        if '/' in key:
            config, key = self._resolve(key)
            return config.update(key, func)
        self.entries[key] = _cleanup_value(func(self.entries.get(key, None)))
        return self.entries[key]

    def __setitem__(self, key, value):
        self.update(key, lambda *_: value)
        return self

    def merge(self, config_override):
        """Recursively overwrites entries with those of ``config_override``."""
        for key, val in _cleanup_value(config_override).items():
            if not isinstance(val, dict):
                self.entries[key] = val
            else:
                self.get(key, {}).merge(val)
        return self

    def copy(self):
        """Returns a deep copy."""
        return Config(self)

    def derive(self, config_override):
        """Returns a deep copy with ``config_override`` merged in."""
        return self.copy().merge(config_override)

    def dump_json(self, fp):
        """Writes the JSON representation to file pointer ``fp``."""
        json.dump(self.entries, fp)

    @property
    def md5(self):
        """MD5 hash object over the JSON representation of the entries.

        Keys are sorted so that the digest is insertion-order independent
        (the reference hashes in insertion order,
        ``superdsm/config.py:178-182``, which makes pickup
        digests fragile against config reordering).
        """
        return hashlib.md5(json.dumps(self.entries, sort_keys=True).encode('utf8'))

    def __str__(self):
        return json.dumps(self.entries, indent=2)

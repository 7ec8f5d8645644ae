"""Hierarchical console/Jupyter progress output.

Re-design of the reference's ``superdsm/output.py`` (see
``superdsm/output.py:21-211``): hierarchical outputs with
muting and margins, *intermediate* lines that are overwritten in place on a
terminal, and a factory :func:`get_output` accepting ``None`` / ``'muted'`` /
an existing :class:`Output`.
"""

import os
import sys


def is_jupyter_notebook():
    try:
        shell = get_ipython().__class__.__name__  # noqa: F821
        return shell == 'ZMQInteractiveShell'
    except NameError:
        return False


def get_output(out=None):
    """Returns an :class:`Output` instance.

    ``None`` yields the default output for the current frontend, ``'muted'``
    yields a muted output, and an existing :class:`Output` is passed through.
    """
    if out is None:
        return JupyterOutput() if is_jupyter_notebook() else ConsoleOutput()
    if isinstance(out, str) and out == 'muted':
        return get_output(None).derive(muted=True)
    assert isinstance(out, Output)
    return out


class Text:
    """ANSI text styling helpers."""

    PURPLE    = '\033[95m'
    CYAN      = '\033[96m'
    DARKCYAN  = '\033[36m'
    BLUE      = '\033[94m'
    GREEN     = '\033[92m'
    YELLOW    = '\033[93m'
    RED       = '\033[91m'
    BOLD      = '\033[1m'
    UNDERLINE = '\033[4m'
    END       = '\033[0m'

    @staticmethod
    def style(text, style):
        return f'{style}{text}{Text.END}'


class Output:
    """Base class of hierarchical outputs.

    :ivar parent: The output this one derives from (or ``None``).
    :ivar muted: Whether writing is suppressed.
    :ivar margin: Number of spaces prepended to each line.
    """

    def __init__(self, parent=None, muted=False, margin=0):
        self.parent = parent
        self.muted = muted
        self.margin = margin

    @property
    def root(self):
        return self if self.parent is None else self.parent.root

    def derive(self, muted=False, margin=0):
        """Returns a derived output, optionally muted or indented further."""
        raise NotImplementedError()

    def intermediate(self, line):
        """Writes a line that the next write may overwrite (terminal only)."""
        raise NotImplementedError()

    def write(self, line):
        """Writes a permanent line."""
        raise NotImplementedError()


class ConsoleOutput(Output):
    """Output to a terminal, with ``\\r``-rewritten intermediate lines.

    Intermediate output can be disabled globally via the environment variable
    ``SUPERDSM_INTERMEDIATE_OUTPUT=false`` (mirrors the reference's
    kill-switch, ``superdsm/output.py:191``).
    """

    def __init__(self, parent=None, muted=False, margin=0):
        super().__init__(parent, muted, margin)
        self._intermediate_line_length = 0

    def derive(self, muted=False, margin=0):
        return ConsoleOutput(self, self.muted or muted, self.margin + margin)

    @property
    def _intermediate_enabled(self):
        return os.environ.get('SUPERDSM_INTERMEDIATE_OUTPUT', 'true').lower() not in ('false', '0', 'no')

    def _clear_intermediate(self):
        root = self.root
        if root._intermediate_line_length > 0:
            sys.stdout.write('\r' + ' ' * root._intermediate_line_length + '\r')
            root._intermediate_line_length = 0

    def intermediate(self, line):
        if self.muted or not self._intermediate_enabled:
            return
        text = ' ' * self.margin + line
        self._clear_intermediate()
        sys.stdout.write(text + '\r')
        sys.stdout.flush()
        self.root._intermediate_line_length = len(text)

    def write(self, line):
        if self.muted:
            return
        self._clear_intermediate()
        for row in str(line).split('\n'):
            print(' ' * self.margin + row)


class JupyterOutput(Output):
    """Output to a Jupyter notebook cell, using ``IPython.display``."""

    def __init__(self, parent=None, muted=False, margin=0):
        super().__init__(parent, muted, margin)
        self._display_handle = None

    def derive(self, muted=False, margin=0):
        return JupyterOutput(self, self.muted or muted, self.margin + margin)

    def intermediate(self, line):
        if self.muted:
            return
        try:
            from IPython.display import display, HTML
        except ImportError:
            return
        text = ' ' * self.margin + line
        if self._display_handle is None:
            self._display_handle = display(HTML(f'<pre>{text}</pre>'), display_id=True)
        else:
            self._display_handle.update(HTML(f'<pre>{text}</pre>'))

    def write(self, line):
        if self.muted:
            return
        self._display_handle = None
        for row in str(line).split('\n'):
            print(' ' * self.margin + row)

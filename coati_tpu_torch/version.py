"""Version machinery (reference src/verb.hpp:31-49, src/lib/version.cc:37-50).

The reference cross-checks the version number compiled into each verb
executable's headers against the one in libcoati at runtime. The Python
analog checks the package version seen by the CLI entry point against the
library's, guarding against a stale installed copy shadowing the source
tree. The integer encoding matches src/meson.build:30:
(major*1000 + minor)*10000 + patch.
"""

from __future__ import annotations

import sys

from coati_tpu_torch import __version__


def version_integer_from_string(version: str) -> int:
    major, minor, patch = (int(x) for x in version.split("-")[0].split("."))
    if not 0 <= minor < 1000:
        raise ValueError("minor version must be less than 1000.")
    if not 0 <= patch < 10000:
        raise ValueError("patch version must be less than 10000.")
    return (major * 1000 + minor) * 10000 + patch


VERSION_INTEGER = version_integer_from_string(__version__)


def version_integer() -> int:
    """Library version as an integer (version.cc:57)."""
    return VERSION_INTEGER


def version_number_check_equal(version_int: int) -> bool:
    """True iff version_int matches the library version (version.cc:44-46)."""
    return version_int == VERSION_INTEGER


def check_version_number(expected: int = VERSION_INTEGER) -> int:
    """Runtime header/library cross-check (verb.hpp:31-42). Returns 0 on
    success, nonzero (and prints to stderr) on mismatch."""
    if not version_number_check_equal(expected):
        print(
            f"ERROR: Version mismatch between headers (#{expected}) and "
            f"library (#{version_integer()}).",
            file=sys.stderr,
        )
        print("       coati-tpu linked against wrong version of library.",
              file=sys.stderr)
        return 1
    return 0

"""pytest loads this file at start-up, in the controlling process and in
every xdist worker, before it imports any test module: so the JAX
package's native library is built once, whole, before any skip mark or
test asks for it (``tests/test_torch_native_prebuild.py``)."""

import test_torch_native_prebuild  # noqa: F401  (builds at import)

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# Several test processes share the host's cores: a torch pool the size of
# the host in each of them starves the service's own threads.
import torch  # noqa: E402

torch.set_num_threads(2)

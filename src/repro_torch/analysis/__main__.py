import sys

from repro_torch.analysis.lint import main

sys.exit(main())

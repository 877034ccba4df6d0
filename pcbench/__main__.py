import sys

from pcbench.run import main

sys.exit(main())

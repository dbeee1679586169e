import sys

from .cli import main

if __name__ == "__main__":  # importing the package walks this module too
    sys.exit(main())

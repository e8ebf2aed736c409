from ..utils import compile_cache
from .cli import main

if __name__ == "__main__":
    compile_cache.enable()
    raise SystemExit(main())

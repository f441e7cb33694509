from .cli.main import main
from .parallel import shutdown

try:
    main()
finally:
    shutdown()  # leave the process group of a multi-rank launch

from .launch import main
import sys

sys.exit(main())

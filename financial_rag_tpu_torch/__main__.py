"""`python -m financial_rag_tpu_torch` starts the search API server on the GPU
(``FRAG_PLATFORM=cpu`` serves from the CPU): the operator script
``financial_rag_tpu_torch.scripts.serve``, with its flags."""

import sys

from financial_rag_tpu_torch.scripts.serve import main

if __name__ == "__main__":
    sys.exit(main())

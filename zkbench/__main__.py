"""python -m zkbench --workload <name> --seed <n> --seconds <s> --trace <0|1>"""

if __name__ == "__main__":
    import sys

    from zkbench.run import main

    sys.exit(main())

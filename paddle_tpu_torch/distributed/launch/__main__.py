from .main import main

if __name__ == "__main__":      # not when a module walk imports it
    main()
